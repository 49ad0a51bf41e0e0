"""The port's SpeechEditor (a3t_tpu_torch/inference/sedit.py) against
``a3t_tpu.inference.SpeechEditor`` with the same tiny model, vocoder weights
and noise.  Span boundaries must be equal as integers; mel and waveforms
agree within atol 1e-4 (fp32 on the CPU: the front-end, the model and the
vocoder sum in another order; values are O(1))."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.inference import SpeechEditor as JaxSpeechEditor
from a3t_tpu.inference import UtteranceAlignment as JaxAlignment
from a3t_tpu.inference import sedit as jsedit
from a3t_tpu.models import A3TMLMModel, A3TModelConfig, EncoderConfig
from a3t_tpu.models.pwg import ParallelWaveGANGenerator, PWGConfig
from a3t_tpu.text import TokenIDConverter as JaxTokens
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state, pwg_state
from a3t_tpu_torch.dsp import LogMelConfig
from a3t_tpu_torch.inference import SpeechEditor, UtteranceAlignment
from a3t_tpu_torch.inference import sedit as tsedit
from a3t_tpu_torch.models import build_model, build_vocoder
from a3t_tpu_torch.models import A3TModelConfig as PortModelConfig
from a3t_tpu_torch.models import EncoderConfig as PortEncoderConfig
from a3t_tpu_torch.models import PWGConfig as PortPWGConfig
from a3t_tpu_torch.text import TokenIDConverter

ATOL = 1e-4
FE = dict(fs=8000, n_fft=256, hop_length=64, win_length=256, n_mels=20,
          fmin=20, fmax=4000)
ENC = dict(attention_dim=32, attention_heads=2, linear_units=64,
           num_blocks=1, cnn_module_kernel=7)
PWG = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
           skip_channels=8, aux_channels=20, upsample_scales=(4, 16))
SECS, N_PHONES = 1.5, 12


def _noise(n_samples):
    return np.random.default_rng(5).standard_normal(
        (1, n_samples)).astype(np.float32)


@pytest.fixture(scope="module")
def editors():
    """(jax editor, port editor, wav, jax alignment, port alignment)."""
    rng = np.random.default_rng(0)
    jcfg = A3TModelConfig(odim=20, vocab_size=30, encoder=EncoderConfig(**ENC),
                          decoder=EncoderConfig(**ENC), postnet_layers=2,
                          postnet_chans=16)
    jm = A3TMLMModel(jcfg)
    dummy = dict(speech=jnp.zeros((1, 64, 20)), text=jnp.zeros((1, 8), jnp.int32),
                 masked_position=jnp.zeros((1, 64), bool),
                 speech_mask=jnp.ones((1, 64), bool),
                 text_mask=jnp.ones((1, 8), bool),
                 speech_segment_pos=jnp.zeros((1, 64), jnp.int32),
                 text_segment_pos=jnp.zeros((1, 8), jnp.int32))
    v = jax.tree_util.tree_map(np.asarray,
                               jm.init(jax.random.PRNGKey(0), **dummy))
    jg = ParallelWaveGANGenerator(PWGConfig(**PWG))
    gv = jax.tree_util.tree_map(np.asarray, jg.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 20)), jnp.zeros((1, 256, 1))))

    port_model = build_model(PortModelConfig(
        odim=20, vocab_size=30, encoder=PortEncoderConfig(**ENC),
        decoder=PortEncoderConfig(**ENC), postnet_layers=2, postnet_chans=16),
        device="cpu")
    load_state(port_model, mlm_state(v))
    port_pwg = build_vocoder(PortPWGConfig(**PWG), device="cpu")
    load_state(port_pwg, pwg_state(gv))

    n = int(SECS * FE["fs"])
    wav = (0.3 * np.sin(2 * np.pi * 180 * np.arange(n) / FE["fs"])
           + 0.01 * rng.standard_normal(n)).astype(np.float32)
    bounds = np.linspace(0, SECS, N_PHONES + 1)
    phones = [f"P{i % 6}" for i in range(N_PHONES)]
    w2p = {f"{i}_{p.upper()}": [p] for i, p in enumerate(phones)}
    lexicon = {p.upper(): [p] for p in set(phones)}
    lexicon["Q"] = ["P1", "P2"]
    tokens = ["<blank>", "<unk>"] + sorted(set(phones)) + ["<sos/eos>"]
    durations = lambda ph, w: [0.11] * len(ph)  # noqa: E731

    jax_editor = JaxSpeechEditor(
        jm, v, JaxLogMelConfig(**FE), JaxTokens(tokens),
        vocoder=lambda m: jg.apply(gv, m, jnp.asarray(
            _noise(m.shape[1] * 64)[..., None])),
        duration_fn=durations, lexicon=lexicon)
    port_editor = SpeechEditor(
        port_model, LogMelConfig(**FE), TokenIDConverter(tokens),
        vocoder=lambda m: port_pwg(m, torch.tensor(_noise(m.shape[1] * 64))),
        duration_fn=durations, lexicon=lexicon, device="cpu")
    return (jax_editor, port_editor, wav, phones,
            JaxAlignment(phones, bounds[:-1], bounds[1:], w2p),
            UtteranceAlignment(phones, bounds[:-1], bounds[1:], w2p))


@pytest.mark.parametrize("span", [(4, 8), (0, 3), (9, 12)])
def test_reconstruct_masked_span(editors, span):
    je, te, wav, phones, ja, ta = editors
    words = " ".join(phones)
    masked = " ".join(phones[:span[0]] + ["[MASK]"] + phones[span[1]:])
    r1 = je.reconstruct_masked_span(wav, ja, words, masked)
    r2 = te.reconstruct_masked_span(wav, ta, words, masked)
    assert r2.old_span_boundary == r1.old_span_boundary
    assert r2.new_span_boundary == r1.new_span_boundary
    assert r2.mel_edited.shape == r1.mel_edited.shape
    np.testing.assert_allclose(r2.mel_edited, r1.mel_edited, atol=ATOL)
    np.testing.assert_allclose(r2.mel_original, r1.mel_original, atol=ATOL)
    np.testing.assert_allclose(r2.prediction, np.asarray(r1.prediction),
                               atol=ATOL)
    np.testing.assert_allclose(r2.origin_replaced, r1.origin_replaced,
                               atol=ATOL)


def test_prompt_tts(editors):
    je, te, wav, phones, ja, ta = editors
    words = " ".join(phones)
    p1 = je.prompt_tts(wav, ja, words, words + " Q P3")
    p2 = te.prompt_tts(wav, ta, words, words + " Q P3")
    assert p2["full"].shape == p1["full"].shape
    np.testing.assert_allclose(p2["new_wav"], p1["new_wav"], atol=ATOL)
    np.testing.assert_allclose(p2["full"], p1["full"], atol=ATOL)


def test_edit_replacement(editors):
    je, te, wav, phones, ja, ta = editors
    words = " ".join(phones)
    new = " ".join(phones[:5] + ["Q"] + phones[7:])
    e1 = je.edit(wav, ja, words, new)
    e2 = te.edit(wav, ta, words, new)
    assert e2.old_span_boundary == e1.old_span_boundary
    assert e2.new_span_boundary == e1.new_span_boundary
    np.testing.assert_allclose(e2.mel_edited, e1.mel_edited, atol=ATOL)
    np.testing.assert_allclose(e2.origin_replaced, e1.origin_replaced,
                               atol=ATOL)


@pytest.mark.parametrize("old,new", [
    ("A B C D", "A B X D"),          # one word replaced
    ("A B C D", "A B C D E F"),      # append (prompt TTS)
    ("A B C D", "X Y"),              # full-utterance replacement keeps X Y
    ("A B C D", "A [MASK] D"),
    ("A B C D", "A B B D"),          # diff collapses: widened by one phone
])
def test_diff_phone_spans_equal(old, new):
    lexicon = {w: [w.lower(), w.lower() + "2"] for w in "ABCDEFXY"}
    words = old.split()
    w2p = {}
    phones = []
    for i, w in enumerate(words):
        w2p[f"{i}_{w}"] = lexicon[w]
        phones += lexicon[w]
    starts = np.arange(len(phones)) * 0.1
    ja = JaxAlignment(phones, starts, starts + 0.1, w2p)
    ta = UtteranceAlignment(phones, starts, starts + 0.1, w2p)
    assert tsedit.diff_phone_spans(ta, old, new, lexicon) == \
        jsedit.diff_phone_spans(ja, old, new, lexicon)


def test_duration_adjust_factor_and_words2phns(rng):
    ori = rng.uniform(0.05, 0.2, 9)
    pred = rng.uniform(0.05, 0.2, 9)
    phns = ["a", "sp", "b", "c", "d", "e", "sp", "f", "g"]
    assert tsedit.duration_adjust_factor(ori, pred, phns) == \
        jsedit.duration_adjust_factor(ori, pred, phns)
    lexicon = {"HELLO": ["HH", "AH0"], "WORLD": ["W", "ER1"]}
    g2p = lambda w: list(w.lower())  # noqa: E731
    line = "Hello, [MASK] 'world- zz."
    assert tsedit.words2phns(line, lexicon, g2p) == \
        jsedit.words2phns(line, lexicon, g2p)


def test_griffin_lim_is_not_ported(editors):
    _, te, wav, phones, _, ta = editors
    editor = SpeechEditor(te.model, te.fe.config, te.tokens,
                          lexicon=te.lexicon, device="cpu")
    words = " ".join(phones)
    with pytest.raises(NotImplementedError):
        editor.reconstruct_masked_span(
            wav, ta, words, " ".join(phones[:4] + ["[MASK]"] + phones[8:]))
