"""The port's A3TMLMModel forward (a3t_tpu_torch/models/mlm.py) against
``a3t_tpu.models.A3TMLMModel.apply(train=False)``, weights carried across by
a3t_tpu_torch/compat/from_jax.py, for the tiny config of __graft_entry__.py
(speaker embedding off) and for the full widths of
configs/a3t_conformer_24k.yaml at a short length.  fp32 on the CPU; the JAX
model takes its XLA attention branch here (conformer.py:216-219), so the
port's plain branch is the counterpart, and its flash branch (the kernel's
plain version on the CPU) must agree as well.  The port's state dict also
goes back through a3t_tpu's own convert_model_state."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.compat.torch_import import convert_model_state
from a3t_tpu.models import A3TMLMModel, A3TModelConfig, EncoderConfig
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.models import mlm as tm
from a3t_tpu_torch.models.conformer import EncoderConfig as PortEncoderConfig
from a3t_tpu_torch.tasks.config import a3t_conformer_24k


def port_config(cfg: A3TModelConfig, flash: bool = True) -> tm.A3TModelConfig:
    """The port's config holding the same values as a JAX config."""
    def enc(e):
        names = {f.name for f in dataclasses.fields(PortEncoderConfig)}
        kw = {k: v for k, v in dataclasses.asdict(e).items() if k in names}
        return PortEncoderConfig(**{**kw, "use_flash_attention": flash})

    names = {f.name for f in dataclasses.fields(tm.A3TModelConfig)}
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name in names and f.name not in ("encoder", "decoder")}
    return tm.A3TModelConfig(
        encoder=enc(cfg.encoder),
        decoder=None if cfg.decoder is None else enc(cfg.decoder), **kw)


def make_batch(rng, b, n_frames, n_text, odim, vocab):
    batch = dict(
        speech=rng.standard_normal((b, n_frames, odim)).astype(np.float32),
        text=rng.integers(0, vocab, (b, n_text)).astype(np.int32),
        masked_position=rng.random((b, n_frames)) < 0.3,
        speech_mask=np.ones((b, n_frames), bool),
        text_mask=np.ones((b, n_text), bool),
        speech_segment_pos=rng.integers(0, n_text + 1, (b, n_frames)
                                        ).astype(np.int32),
        text_segment_pos=rng.integers(0, n_text + 1, (b, n_text)
                                      ).astype(np.int32))
    if b > 1:
        batch["speech_mask"][1, -7:] = False
        batch["text_mask"][1, -2:] = False
    return batch


def jax_variables(model, batch, rng):
    v = model.init(jax.random.PRNGKey(0),
                   **{k: jnp.asarray(a) for k, a in batch.items()})
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.1, 0.6, s.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def run_port(model, batch):
    with torch.no_grad():
        return model(**{k: torch.tensor(a) for k, a in batch.items()})


def tiny_config():
    enc = EncoderConfig(attention_dim=64, attention_heads=2, linear_units=128,
                        num_blocks=2, cnn_module_kernel=7)
    return A3TModelConfig(odim=20, vocab_size=40, encoder=enc, decoder=enc,
                          postnet_layers=2, postnet_chans=16)


@pytest.mark.parametrize("flash", [True, False])
def test_tiny_forward_matches_jax(rng, flash):
    """before/after outputs within atol 1e-4 (fp32 sums over two stacks)."""
    cfg = tiny_config()
    batch = make_batch(rng, 2, 32, 6, 20, 40)
    jm = A3TMLMModel(cfg)
    v = jax_variables(jm, batch, rng)
    jb, ja, _ = jm.apply(v, **{k: jnp.asarray(a) for k, a in batch.items()})
    model = tm.build_model(port_config(cfg, flash), device="cpu")
    load_state(model, mlm_state(v))
    before, after = run_port(model, batch)
    np.testing.assert_allclose(before.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(after.numpy(), np.asarray(ja), atol=1e-4)


def test_port_state_dict_runs_in_jax(rng):
    """port state_dict -> a3t_tpu convert_model_state -> the same outputs."""
    cfg = tiny_config()
    batch = make_batch(rng, 2, 24, 5, 20, 40)
    model = tm.build_model(port_config(cfg), device="cpu", seed=3)
    with torch.no_grad():  # BatchNorm statistics away from (0, 1)
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
            elif name.endswith("running_mean"):
                buf.uniform_(-0.3, 0.3)
    before, after = run_port(model, batch)
    variables = convert_model_state(model.state_dict())
    jb, ja, _ = A3TMLMModel(cfg).apply(
        variables, **{k: jnp.asarray(a) for k, a in batch.items()})
    np.testing.assert_allclose(np.asarray(jb), before.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ja), after.numpy(), atol=1e-4)


def test_full_width_forward_matches_jax(rng):
    """configs/a3t_conformer_24k.yaml widths (d=384, 2 heads of 192, 4+4
    blocks, k=7/31, postnet 5x256) at 64 frames + 8 tokens: atol 2e-4 on
    outputs of O(1..10)."""
    cfg = A3TModelConfig(vocab_size=80)
    port = a3t_conformer_24k(vocab_size=80)
    assert port == port_config(cfg)
    batch = make_batch(rng, 1, 64, 8, 80, 80)
    jm = A3TMLMModel(cfg)
    v = jax_variables(jm, batch, rng)
    jb, ja, _ = jm.apply(v, **{k: jnp.asarray(a) for k, a in batch.items()})
    model = tm.build_model(port, device="cpu")
    load_state(model, mlm_state(v))
    before, after = run_port(model, batch)
    np.testing.assert_allclose(before.numpy(), np.asarray(jb), atol=2e-4)
    np.testing.assert_allclose(after.numpy(), np.asarray(ja), atol=2e-4)


def test_seeded_weights_are_reproducible():
    cfg = port_config(tiny_config())
    a = tm.build_model(cfg, device="cpu", seed=7).state_dict()
    b = tm.build_model(cfg, device="cpu", seed=7).state_dict()
    c = tm.build_model(cfg, device="cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sfc.weight"], c["sfc.weight"])


def test_unported_variants_raise():
    """The duration-aware variant raises naming its ROADMAP item; a
    speaker-conditioned model builds (tests/test_torch_spemb.py holds it
    against JAX)."""
    cfg = port_config(tiny_config())
    model = tm.A3TMLMModel(dataclasses.replace(cfg, spemb_dim=16))
    assert model.spemb_proj.in_features == 16
    with pytest.raises(NotImplementedError, match="A9"):
        tm.A3TMLMModel(dataclasses.replace(cfg, duration_predictor_layers=2))
