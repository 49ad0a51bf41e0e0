"""The port's FastSpeech2 path (a3t_tpu_torch/models/{conformer,attention,
layers,gst,fastspeech2}.py, dsp/pitch.py, tasks/fs2.py) against the JAX
package on the CPU, at tiny widths, weights carried across by
compat/from_jax.py::fs2_state.

Tolerances (fp32; the two frameworks sum the same products in another
order):

* attention kinds, the scaled positional encoding, GST, the predictors and
  the FastSpeech2 forward: atol 1e-5 on outputs of O(1) (read 1e-6 to
  3e-6), the positional tables 1e-6;
* integer durations: equal, except where exp(x) - 1 lies within 1e-5 of a
  .5 (the log-durations' tolerance), where a rounding may go either way;
* the length regulator and its mask: equal;
* one dropout-0 train step: loss rtol 2e-5, grad_norm rtol 2e-4, each
  parameter and running statistic after the update atol 2e-5 (Adam's first
  step moves a parameter by at most lr_0 = 5.6e-3 here);
* dsp/pitch.py and FS2Batcher: bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.dsp import pitch as jax_pitch
from a3t_tpu.models import conformer as jax_conformer
from a3t_tpu.models import fastspeech2 as jax_fs2
from a3t_tpu.models import gst as jax_gst
from a3t_tpu.models import layers as jax_layers
from a3t_tpu.tasks import fs2 as jax_fs2_task
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.dsp import pitch
from a3t_tpu_torch.models import conformer as tc
from a3t_tpu_torch.models import fastspeech2 as tf
from a3t_tpu_torch.models.gst import StyleEncoder
from a3t_tpu_torch.models.layers import (DurationPredictor, VariancePredictor,
                                         duration_loss)
from a3t_tpu_torch.tasks import fs2 as port_fs2_task
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train import OptimConfig, create_train_state, make_optimizer

ATOL = 1e-5
TOL_LOG_D = 1e-5
PARAM_ATOL = 2e-5
FE = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200, n_mels=16)
GST = dict(gst_tokens=4, gst_heads=2, gst_conv_chans_list=(4, 4, 8),
           gst_gru_units=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_stack(e) -> tc.EncoderConfig:
    names = {f.name for f in dataclasses.fields(tc.EncoderConfig)}
    return tc.EncoderConfig(**{k: v for k, v in dataclasses.asdict(e).items()
                               if k in names})


def port_fs2_config(c) -> tf.FastSpeech2Config:
    """The port's FastSpeech2Config holding a JAX config's values."""
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    kw.update(encoder=port_stack(c.encoder), decoder=port_stack(c.decoder))
    return tf.FastSpeech2Config(**kw)


def jax_fs2_config(c) -> jax_fs2.FastSpeech2Config:
    """The JAX FastSpeech2Config holding a port config's values."""
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    kw.update(encoder=jax_conformer.EncoderConfig(
                  **dataclasses.asdict(c.encoder)),
              decoder=jax_conformer.EncoderConfig(
                  **dataclasses.asdict(c.decoder)))
    return jax_fs2.FastSpeech2Config(**kw)


def tiny_fs2_config(conformer: bool, use_gst: bool = True,
                    integration: str = "add", dropout: float = 0.0,
                    **kw) -> jax_fs2.FastSpeech2Config:
    if conformer:
        enc = jax_conformer.EncoderConfig(
            attention_dim=16, attention_heads=2, linear_units=32,
            num_blocks=1, cnn_module_kernel=7,
            positionwise_conv_kernel_size=3, dropout_rate=dropout,
            positional_dropout_rate=dropout, attention_dropout_rate=dropout)
        dec = dataclasses.replace(enc, cnn_module_kernel=31)
    else:
        enc = dec = jax_fs2.transformer_stack_config(16, 2, 1, 32, dropout)
    return jax_fs2.FastSpeech2Config(
        idim=20, odim=16, adim=16, encoder=enc, decoder=dec,
        encoder_conformer=conformer, postnet_layers=2, postnet_chans=8,
        duration_predictor_chans=8, variance_predictor_chans=8,
        pitch_predictor_layers=3, pitch_predictor_kernel=5,
        pitch_embed_kernel=1, energy_embed_kernel=1, use_gst=use_gst,
        spk_embed_dim=6, spk_embed_integration_type=integration,
        max_feat_len=48, **GST, **kw)


def fs2_inputs(rng, b=2, t=7, frames=40, odim=16, idim=20, spk=6):
    text = rng.integers(1, idim, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, -2:] = False
    return dict(
        text=text, text_mask=mask,
        speech=rng.standard_normal((b, frames, odim)).astype(np.float32),
        spembs=rng.standard_normal((b, spk)).astype(np.float32),
        durations=(rng.integers(0, 6, (b, t)) * mask).astype(np.int32),
        pitch=rng.standard_normal((b, t, 1)).astype(np.float32),
        energy=rng.standard_normal((b, t, 1)).astype(np.float32))


def with_stats(v, rng):
    """Variables with BatchNorm statistics moved away from (0, 1)."""
    v = _np_tree(v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.1, 0.6, s.shape)).astype(np.float32),
        v.get("batch_stats", {}))
    return v


def port_fs2(jax_cfg, variables) -> tf.FastSpeech2:
    model = tf.FastSpeech2(port_fs2_config(jax_cfg)).eval()
    from_jax.load_state(model, from_jax.fs2_state(variables))
    return model


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def assert_durations_match(got, want, log_d):
    """Integer durations equal, except where exp(log_d) - 1 lies within
    the log-durations' tolerance of a .5."""
    x = np.exp(np.asarray(log_d, np.float64)) - 1.0
    near = np.abs(x - np.floor(x) - 0.5) < TOL_LOG_D * np.exp(
        np.asarray(log_d, np.float64))
    np.testing.assert_array_equal(np.asarray(got)[~near],
                                  np.asarray(want)[~near])


# -- attention kinds and positional encodings ----------------------------------

@pytest.mark.parametrize("kind", ["selfattn", "rel_selfattn"])
def test_attention_kinds_match_jax(rng, kind):
    """A two-block stack of plain (selfattn, macaron and conv module off,
    as the transformer FS2) or latest rel-pos attention (rel_selfattn, a
    conformer) against JAX's, with a padded key tail."""
    conformer = kind == "rel_selfattn"
    cfg = jax_conformer.EncoderConfig(
        attention_dim=16, attention_heads=2, linear_units=32, num_blocks=2,
        cnn_module_kernel=5, macaron_style=conformer,
        use_cnn_module=conformer, selfattention_layer_type=kind,
        positionwise_conv_kernel_size=3)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    mask = np.ones((2, 1, 11), bool)
    mask[1, 0, -3:] = False
    pos = None
    if conformer:
        pos = np.asarray(jax_conformer.RelPosEncoding(16, 0.0, legacy=False)
                         .apply({}, jnp.asarray(x))[1])
        port_x, port_pos = tc.RelPosEncoding(16, legacy=False)(torch.tensor(x))
        np.testing.assert_allclose(port_pos.numpy(), pos, atol=1e-6)
        assert pos.shape == (1, 21, 16)
    stack = jax_conformer.ConformerStack(cfg)
    v = with_stats(stack.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              None if pos is None else jnp.asarray(pos),
                              jnp.asarray(mask), False), rng)
    want = np.asarray(stack.apply(v, jnp.asarray(x), None if pos is None
                                  else jnp.asarray(pos), jnp.asarray(mask),
                                  False))
    for flash in (True, False):
        mod = tc.ConformerStack(port_stack(dataclasses.replace(
            cfg, use_flash_attention=flash))).eval()
        from_jax.load_state(mod, {k.split(".", 1)[1]: a for k, a in
                                  from_jax.stack(v["params"], v["batch_stats"],
                                                 "m").items()})
        with torch.no_grad():
            got = mod(torch.tensor(x), None if pos is None
                      else torch.tensor(pos), torch.tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_scaled_abs_posenc_matches_jax(rng):
    """ScaledPositionalEncoding: x + alpha * pe, x not scaled by sqrt(d);
    the unscaled form keeps x * sqrt(d) + pe."""
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    for scaled in (True, False):
        enc = jax_conformer.AbsPosEncoding(16, 0.0, scaled=scaled)
        v = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))
        if scaled:
            v = {"params": {"alpha": jnp.asarray(0.7, jnp.float32)}}
        want = np.asarray(enc.apply(v, jnp.asarray(x)))
        mod = tc.AbsPosEncoding(16, scaled=scaled)
        if scaled:
            mod.alpha.data.fill_(0.7)
        got, none = mod(torch.tensor(x))
        assert none is None
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)


# -- GST ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gst_case():
    rng = np.random.default_rng(4)
    speech = rng.standard_normal((3, 37, 16)).astype(np.float32)
    jm = jax_gst.StyleEncoder(gst_tokens=4, gst_token_dim=16, gst_heads=2,
                              conv_chans_list=(4, 4, 8), gru_units=8)
    v = with_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(speech)), rng)
    return speech, jm, v


@pytest.mark.parametrize("train", [False, True])
def test_gst_matches_jax(gst_case, train):
    """The style encoder in eval mode (running statistics) and in train
    mode (batch statistics over (B, T', F'), the running statistics moved
    by flax's rule); the GRU's torch weights from flax's GRUCell."""
    speech, jm, v = gst_case
    mod = StyleEncoder(idim=16, gst_tokens=4, gst_token_dim=16, gst_heads=2,
                       conv_chans_list=(4, 4, 8), gru_units=8)
    from_jax.load_state(mod, {k[4:]: a for k, a in from_jax.gst(
        v["params"], v["batch_stats"], "gst").items()})
    mod.train(train)
    if train:
        want, upd = jm.apply(v, jnp.asarray(speech), True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(speech), False)
    got = mod(torch.tensor(speech))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    if train:
        stats = _np_tree(upd["batch_stats"])["ref_enc"]
        for i in range(3):
            bn = mod.ref_enc.convs[3 * i + 1]
            for ours, theirs in ((bn.running_mean, "mean"),
                                 (bn.running_var, "var")):
                np.testing.assert_allclose(
                    ours.numpy(), stats[f"BatchNorm_{i}"][theirs], atol=1e-6)


# -- predictors, durations, length regulator ------------------------------------

def test_predictors_match_jax(rng):
    """Duration and variance predictors with a padded tail (zero there),
    to_durations on values at and around .5 (half to even, as jnp.round),
    and the duration loss."""
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[1, -3:] = True
    for jmod, pmod, squeeze in (
            (jax_layers.DurationPredictor(2, 8, 3), DurationPredictor(16, 2, 8),
             True),
            (jax_fs2.VariancePredictor(3, 8, 5, 0.5),
             VariancePredictor(16, 3, 8, 5), False)):
        v = _np_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        p = v["params"]
        from_jax.load_state(pmod, {k[2:]: a for k, a in
                                   from_jax.predictor(p, "m").items()})
        want = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(pad)))
        got = pmod.eval()(torch.tensor(x), torch.tensor(pad))
        assert got.shape == ((2, 9) if squeeze else (2, 9, 1))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
        assert (got.detach().numpy()[pad] == 0).all()
    log_d = np.log(np.array([0.5, 1.0, 1.5, 2.5, 3.5, 4.49, 4.51, 0.0, 7.0])
                   + 1.0).astype(np.float32)
    want = np.asarray(jax_layers.DurationPredictor.to_durations(
        jnp.asarray(log_d)))
    got = DurationPredictor.to_durations(torch.tensor(log_d)).numpy()
    np.testing.assert_array_equal(got, want)
    target = rng.integers(0, 9, (2, 9))
    np.testing.assert_allclose(
        duration_loss(torch.tensor(x[..., 0]), torch.tensor(target)).numpy(),
        np.asarray(jax_layers.duration_loss(jnp.asarray(x[..., 0]),
                                            jnp.asarray(target))), atol=1e-6)


@pytest.mark.parametrize("max_len", [12, 20, 40])
def test_length_regulate_matches_jax(rng, max_len):
    """Totals below, at and past max_len (cut), zero durations, an
    all-zero row: the states and the mask equal JAX's."""
    hs = rng.standard_normal((3, 6, 4)).astype(np.float32)
    d = np.array([[3, 0, 2, 4, 1, 5], [0, 0, 0, 0, 0, 0],
                  [6, 6, 6, 6, 6, 6]], np.int32)
    want, want_valid = jax_fs2.length_regulate(jnp.asarray(hs),
                                               jnp.asarray(d), max_len)
    got, valid = tf.length_regulate(torch.tensor(hs), torch.tensor(d),
                                    max_len)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the FastSpeech2 forward and loss -----------------------------------------

# each form, GST and each x-vector integration at least once (every JAX
# init of a new configuration costs seconds of eager compiles on the CPU)
FORMS = [(False, True, "add"), (True, False, "concat")]


@pytest.mark.parametrize("conformer,use_gst,integration", FORMS)
def test_fs2_forward_matches_jax(rng, conformer, use_gst, integration):
    """Teacher-forced and predicted-duration forwards (alpha 1.3), the
    encoder's hidden states and predict_durations, in the transformer and
    conformer forms, with and without GST, x-vectors added or
    concatenated."""
    cfg = tiny_fs2_config(conformer, use_gst, integration)
    b = fs2_inputs(rng)
    if not use_gst:
        b["speech"] = None
    jb = {k: None if v is None else jnp.asarray(v) for k, v in b.items()}
    jm = jax_fs2.FastSpeech2(cfg)
    v = with_stats(jm.init(jax.random.PRNGKey(0), **jb), rng)
    model = port_fs2(cfg, v)
    pb = {k: None if v is None else torch.tensor(v) for k, v in b.items()}
    pb["durations"] = pb["durations"].long()
    with torch.no_grad():
        got = model(**pb)
        got_free = model(pb["text"], pb["text_mask"], pb["speech"],
                         pb["spembs"], alpha=1.3)
        hs = model.encode_hidden(pb["text"], pb["text_mask"], pb["speech"],
                                 pb["spembs"])
        d = model.predict_durations(pb["text"], pb["text_mask"],
                                    pb["speech"], pb["spembs"])
    want = jm.apply(v, **jb)
    want_free = jm.apply(v, jb["text"], jb["text_mask"], jb["speech"],
                         jb["spembs"], alpha=1.3)
    for k in ("before", "after", "log_duration", "pitch", "energy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["frame_valid"].numpy(),
                                  np.asarray(want["frame_valid"]))
    np.testing.assert_allclose(
        hs.numpy(), np.asarray(jm.apply(v, jb["text"], jb["text_mask"],
                                        jb["speech"], jb["spembs"],
                                        method="encode_hidden")), atol=ATOL)
    want_d = jm.apply(v, jb["text"], jb["text_mask"], jb["speech"],
                      jb["spembs"], method="predict_durations")
    assert_durations_match(d.numpy(), want_d, want["log_duration"])
    assert_durations_match(got_free["durations"].numpy(),
                           want_free["durations"], want["log_duration"])
    if np.array_equal(got_free["durations"].numpy(),
                      np.asarray(want_free["durations"])):
        np.testing.assert_allclose(got_free["after"].numpy(),
                                   np.asarray(want_free["after"]), atol=ATOL)


def test_fastspeech2_loss_matches_jax(rng):
    out = dict(before=rng.standard_normal((2, 10, 4)),
               after=rng.standard_normal((2, 10, 4)),
               log_duration=rng.standard_normal((2, 5)),
               pitch=rng.standard_normal((2, 5, 1)),
               energy=rng.standard_normal((2, 5, 1)),
               frame_valid=rng.random((2, 10)) < 0.7)
    targets = dict(mel=rng.standard_normal((2, 10, 4)),
                   durations=rng.integers(0, 5, (2, 5)),
                   pitch=rng.standard_normal((2, 5, 1)),
                   energy=rng.standard_normal((2, 5, 1)))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)

    def cast(d):
        return {k: v.astype(np.float32) if v.dtype == np.float64 else v
                for k, v in d.items()}

    out, targets = cast(out), cast(targets)
    want = jax_fs2.fastspeech2_loss(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in targets.items()}, jnp.asarray(mask))
    got = tf.fastspeech2_loss(_t(out), _t(targets), torch.tensor(mask))
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


# -- pitch targets and batches ----------------------------------------------------

def test_pitch_matches_jax_bit_for_bit(rng):
    t = np.arange(7000) / 24000
    wav = (0.3 * np.sin(2 * np.pi * 140 * t)
           + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    wav[2000:2600] = 0.0  # an unvoiced stretch
    d = np.array([3, 5, 0, 7, 4, 5])
    got = pitch.fs2_targets(wav, 24000, 2048, 300, 1200, d)
    want = jax_pitch.fs2_targets(wav, 24000, 2048, 300, 1200, d)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["f0_frames"] > 0).any() and (got["f0_frames"] == 0).any()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 24 kHz mini corpus of 7 utterances of 5-12 phones, 3 speakers."""
    root = tmp_path_factory.mktemp("fs2")
    return generate_mini_corpus(str(root / "data"), n_utts=7, fs=24000,
                                n_phones_range=(5, 12))


def _batchers(corpus, spk2xv, **bcfg):
    texts = read_2column_text(f"{corpus}/text").values()
    tokens = build_token_list(texts)
    port = port_fs2_task.FS2Batcher(
        A3TDataset(corpus, TokenIDConverter(tokens)), LogMelConfig(**FE),
        port_fs2_task.FS2BatcherConfig(**bcfg), spk2xvector=spk2xv)
    jax_b = jax_fs2_task.FS2Batcher(
        JaxA3TDataset(corpus, JaxTokenIDConverter(tokens)),
        JaxLogMelConfig(**FE), jax_fs2_task.FS2BatcherConfig(**bcfg),
        spk2xvector=spk2xv)
    return port, jax_b, len(tokens)


def test_fs2_batcher_bit_for_bit(corpus, rng):
    """Two epochs of batches (two text buckets, a short last batch, a
    speaker missing from the x-vector table) equal JAX's bit for bit."""
    spk2xv = {"spk0": rng.standard_normal(6).astype(np.float32),
              "spk1": rng.standard_normal(6).astype(np.float32)}
    port, jax_b, vocab = _batchers(corpus, spk2xv, batch_size=3,
                                   text_buckets=(8, 16), max_feat_len=96)
    for epoch in (1, 2):
        got = list(port.epoch_iterator(epoch, vocab))
        want = list(jax_b.epoch_iterator(epoch, vocab))
        assert len(got) == len(want) >= 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- one train step -----------------------------------------------------------------

OPTIM = dict(lr=1.0, model_size=16, warmup_steps=10, grad_clip=1.0,
             adam_eps=1e-3)


def test_fs2_train_step_matches_jax(corpus, rng):
    """One dropout-0 step of make_fs2_train_step against JAX's, in the
    conformer form with GST and x-vectors (the card's configuration): the
    loss terms, grad_norm, every parameter and running statistic after the
    update.  The duration predictor's fixed dropout 0.1 and the postnet's
    0.5 are set to 0 on both sides (in JAX through the module's namespace,
    leaving the package's files as they are)."""
    spk2xv = {f"spk{i}": rng.standard_normal(6).astype(np.float32)
              for i in range(3)}
    port_b, jax_b, vocab = _batchers(corpus, spk2xv, batch_size=4,
                                     text_buckets=(16,), max_feat_len=48)
    batch = jax_b.make_batch(0, jax_b._buckets[0][:4], vocab)
    cfg = tiny_fs2_config(True, variance_dropout=0.0)
    cfg = dataclasses.replace(cfg, idim=vocab + 1)

    saved = jax_fs2.DurationPredictor, jax_fs2.Postnet
    jax_fs2.DurationPredictor = functools.partial(
        jax_layers.DurationPredictor, dropout_rate=0.0)
    jax_fs2.Postnet = functools.partial(jax_layers.Postnet, dropout_rate=0.0)
    try:
        jm = jax_fs2.FastSpeech2(cfg)
        jfe = JaxLogMelFrontend(JaxLogMelConfig(**FE))
        dev = {k: jnp.asarray(a) for k, a in batch.items()}
        state = jax_fs2_task.create_fs2_state(
            jm, jax_make_optimizer(JaxOptimConfig(**OPTIM)), dev)
        init = with_stats({"params": state.params,
                           "batch_stats": state.batch_stats}, rng)
        state = state.replace(params=init["params"],
                              batch_stats=init["batch_stats"])
        step = jax_fs2_task.make_fs2_train_step(jm, jfe)
        state, want = step(state, dev, jax.random.PRNGKey(0))
        want = {k: float(v) for k, v in want.items()}
        want_state = from_jax.fs2_state(_np_tree(
            {"params": state.params, "batch_stats": state.batch_stats}))
    finally:
        jax_fs2.DurationPredictor, jax_fs2.Postnet = saved

    model = port_fs2(cfg, init)
    model.duration_predictor.conv[0][3].rate = 0.0
    model.duration_predictor.conv[1][3].rate = 0.0
    model.postnet.dropout.rate = 0.0
    st = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                            device="cpu")
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    st, stats = port_fs2_task.make_fs2_train_step(model, fe, device="cpu")(
        st, batch, 0)
    for k in ("loss", "l1_loss", "duration_loss", "pitch_loss",
              "energy_loss"):
        assert float(stats[k]) == pytest.approx(want[k], rel=2e-5), k
    assert float(stats["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                      rel=2e-4)
    assert int(stats["notfinite_count"]) == 0 and st.step == 1
    got = st.model.state_dict()
    for name, value in want_state.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value,
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=name)
