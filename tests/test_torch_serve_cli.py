"""The port's serving and scoring CLIs and the modules under them
(a3t_tpu_torch/bin/sedit.py, bin/mcd_gate.py, inference/baselines.py,
compat/espnet.py, models/pwg.py's checkpoint loader, text/native_g2p.py,
inference/sedit.py's FileAlignmentSource and merge_utterances) against the
JAX package, on the CPU, at a tiny width.

The experiment is written by the port's ``bin.train`` (1+1 blocks of width
16, postnet 1x8, 20 mel bins, one step) on a generated 24 kHz mini corpus;
the JAX side runs the same weights through ``convert_model_state``.
Tolerances:

* the edited mel through the CLI against JAX's SpeechEditor: atol 1e-4
  (fp32; the front-ends and the model sum in another order, values O(1));
  span boundaries equal as integers;
* dynamic evaluation at dropout 0: each adapted parameter within 1e-6 +
  1e-4 of its update's largest size (the gradients differ by summation
  order only; read: 1.8e-5 of the update at most on the leaves that moved,
  1.2e-6 absolute at most; the absolute term covers the biases that
  softmax and BatchNorm ignore, whose gradients are rounding noise);
* the parallel_wavegan and ESPnet loaders: the same weights give the same
  wav or forward within atol 1e-4.
"""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.compat import torch_import as jax_torch_import
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.inference import FileAlignmentSource as JaxFileAlignmentSource
from a3t_tpu.inference import SpeechEditor as JaxSpeechEditor
from a3t_tpu.inference import baselines as jax_baselines
from a3t_tpu.inference import sedit as jax_sedit
from a3t_tpu.models import A3TMLMModel as JaxA3TMLMModel
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.models import pwg as jax_pwg
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.text import native_g2p as jax_g2p
from a3t_tpu_torch.bin import mcd_gate as port_mcd_gate
from a3t_tpu_torch.bin import sedit as port_sedit
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat import espnet
from a3t_tpu_torch.compat.from_jax import mlm_state
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.inference import (FileAlignmentSource, SpeechEditor,
                                     dynamic_evaluation, merge_utterances,
                                     resolve_mask_str)
from a3t_tpu_torch.models import (ParallelWaveGANGenerator, PWGConfig,
                                  build_vocoder, load_pwg_checkpoint)
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.text import letter_to_sound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")
ATOL = 1e-4
N_UTTS = 4


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """(data dir, experiment dir) of one port training run."""
    root = tmp_path_factory.mktemp("serve")
    data = generate_mini_corpus(str(root / "data"), n_utts=N_UTTS, fs=24000,
                                n_phones_range=(5, 9))
    exp_dir = str(root / "exp")
    sets = [f"train_data_dir={data}", "valid_data_dir=''",
            f"exp_dir={exp_dir}", "frontend.n_mels=20",
            "model.postnet_layers=1", "model.postnet_chans=8",
            "batcher.batch_bins=5120", "batcher.bucket_frames=[256]",
            "trainer.max_epoch=1", "trainer.num_iters_per_epoch=1"]
    sets += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
             for k, v in (("attention_dim", 16), ("linear_units", 16),
                          ("num_blocks", 1))]
    argv = ["--config", CONFIG, "--log-level", "WARNING", "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    train_main(argv)
    return data, exp_dir


@pytest.fixture
def jax_letter_to_sound(tmp_path, monkeypatch):
    """JAX's letter_to_sound, its library made by its own Makefile in a
    private copy of native/g2p (so no other process's build races it)."""
    src = os.path.join(ROOT, "native", "g2p")
    dst = tmp_path / "g2p"
    dst.mkdir()
    for name in ("g2p.cc", "Makefile"):
        shutil.copy(os.path.join(src, name), dst / name)
    monkeypatch.setattr(jax_g2p, "_NATIVE_DIR", str(dst))
    monkeypatch.setattr(jax_g2p, "_LIB_PATH", str(dst / "liba3t_g2p.so"))
    monkeypatch.setattr(jax_g2p, "_lib", None)
    return jax_g2p.letter_to_sound


def _jax_config(c):
    """The port's A3TModelConfig as the JAX package's."""
    def stack(e):
        return None if e is None else JaxEncoderConfig(**dataclasses.asdict(e))
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    fields.update(encoder=stack(c.encoder), decoder=stack(c.decoder))
    return JaxA3TModelConfig(**fields)


def _jax_editor(model, cfg_fe, conv, g2p, **kw):
    variables = jax_torch_import.convert_model_state(model.state_dict())
    return JaxSpeechEditor(
        JaxA3TMLMModel(_jax_config(model.config)), variables,
        JaxLogMelConfig(**dataclasses.asdict(cfg_fe)),
        JaxTokenIDConverter(conv.token_list), g2p=g2p, **kw)


# -- host-side modules -------------------------------------------------------

def test_letter_to_sound_matches_jax(jax_letter_to_sound):
    words = ["hello", "world", "nation", "talking", "xylophone", "a", "",
             "Qwerty", "speech", "editing", "reasonable", "villages",
             "language", "knight", "phone", "through"]
    for w in words:
        assert letter_to_sound(w) == jax_letter_to_sound(w), w


def test_letter_to_sound_build_failure_raises(tmp_path, monkeypatch):
    """The engine builds into a3t_tpu_torch/_build/ under a hash of its
    source; a failed build raises, with no Python engine to fall back to,
    and leaves nothing behind."""
    from a3t_tpu_torch.text import native_g2p

    path = native_g2p.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "a3t_tpu_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("liba3t_g2p_")
    monkeypatch.setattr(native_g2p, "_lib", None)
    monkeypatch.setattr(native_g2p, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_g2p, "CXX_FLAGS", ("--no-such-option",))
    with pytest.raises(RuntimeError, match="building native/g2p failed"):
        letter_to_sound("hello")
    assert not os.listdir(tmp_path / "build")


def test_file_alignment_source_and_merge_utterances(exp):
    data, _ = exp
    port, jaxs = FileAlignmentSource(data), JaxFileAlignmentSource(data)
    uids = sorted(read_2column_text(os.path.join(data, "text")))
    for uid in uids:
        a, b = port(uid), jaxs(uid)
        assert a.phones == b.phones and a.word2phns == b.word2phns
        np.testing.assert_array_equal(a.start_sec, b.start_sec)
        np.testing.assert_array_equal(a.end_sec, b.end_sec)
        np.testing.assert_array_equal(a.durations, b.durations)
    ds = A3TDataset(data)
    u1, u2 = uids[:2]
    got = merge_utterances(ds[u1]["audio"], port(u1), "t1",
                           ds[u2]["audio"], port(u2), "t2")
    want = jax_sedit.merge_utterances(ds[u1]["audio"], jaxs(u1), "t1",
                                      ds[u2]["audio"], jaxs(u2), "t2")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == "t1 t2"
    assert got[2].phones == want[2].phones
    assert got[2].word2phns == want[2].word2phns
    np.testing.assert_array_equal(got[2].start_sec, want[2].start_sec)
    np.testing.assert_array_equal(got[2].end_sec, want[2].end_sec)


@pytest.mark.parametrize("new", ["A [MASK] D", "A B C D", "[MASK] C D"])
def test_resolve_mask_str_matches_jax(new):
    phones = ["a", "b", "c", "d"]
    w2p = {f"{i}_{p.upper()}": [p] for i, p in enumerate(phones)}
    lexicon = {p.upper(): [p] for p in phones}
    starts = np.arange(4) * 0.1
    from a3t_tpu_torch.inference import UtteranceAlignment

    a = UtteranceAlignment(phones, starts, starts + 0.1, w2p)
    b = jax_sedit.UtteranceAlignment(phones, starts, starts + 0.1, w2p)
    assert resolve_mask_str(a, "A B C D", new, lexicon) == \
        jax_baselines.resolve_mask_str(b, "A B C D", new, lexicon)


# -- dynamic evaluation ------------------------------------------------------

def test_dynamic_evaluation_matches_jax(exp, monkeypatch):
    """One pass at dropout 0 (the postnet's fixed 0.5 too, as in
    test_torch_train.py): the adapted parameters equal JAX's leaf by leaf;
    the original model's parameters and running statistics are unchanged
    bit for bit, and the adapted model keeps those statistics."""
    data, exp_dir = exp
    model, cfg, conv = MLMTask.build_model_from_dir(exp_dir, device="cpu")
    zero = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                attention_dropout_rate=0.0)
    c0 = dataclasses.replace(
        model.config, encoder=dataclasses.replace(model.config.encoder, **zero),
        decoder=dataclasses.replace(model.config.decoder, **zero))
    from a3t_tpu_torch.models.mlm import A3TMLMModel

    model0 = A3TMLMModel(c0)
    model0.load_state_dict(model.state_dict())
    model0.postnet.dropout.rate = 0.0
    model0.eval()
    monkeypatch.setattr(jax_mlm, "Postnet", functools.partial(
        jax_mlm.Postnet, dropout_rate=0.0))

    uid = sorted(read_2column_text(os.path.join(data, "text")))[0]
    wav = A3TDataset(data)[uid]["audio"]
    align = FileAlignmentSource(data)(uid)
    text = " ".join(align.phones)
    lexicon = port_sedit.phone_lexicon({uid: text})
    editor = SpeechEditor(model0, cfg.frontend, conv, lexicon=lexicon,
                          device="cpu")
    jed = _jax_editor(model0, cfg.frontend, conv, None, lexicon=lexicon)
    jalign = JaxFileAlignmentSource(data)(uid)
    before = {k: v.clone() for k, v in model0.state_dict().items()}

    lr = 1e-2
    adapted = dynamic_evaluation(editor, wav, align, text, lr=lr, steps=1)
    jadapted = jax_baselines.dynamic_evaluation(jed, wav, jalign, text,
                                                lr=lr, steps=1)
    assert adapted is not editor and editor.model is model0
    after = model0.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    got = adapted.model.state_dict()
    want = mlm_state(jax.tree_util.tree_map(np.asarray, jadapted.variables))
    assert not adapted.model.training
    moved = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            assert torch.equal(v, before[k]), k
            continue
        step = np.abs(want[k] - before[k].numpy()).max()
        err = np.abs(v.numpy() - want[k]).max()
        assert err <= 1e-6 + 1e-4 * step, (k, err, step)
        moved += step > 1e-4
    assert moved > len(got) // 4  # the pass moved most leaves


# -- checkpoint loaders ------------------------------------------------------

PWG = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
           skip_channels=8, aux_channels=20, upsample_scales=(4, 16))


def _weight_normed(sd, g):
    """A parallel_wavegan-layout state dict with every conv weight split
    into weight_g (norm over all axes but the first) and weight_v."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() >= 3:
            p = k[: -len(".weight")]
            out[f"{p}.weight_v"] = torch.randn(v.shape, generator=g)
            out[f"{p}.weight_g"] = torch.rand(
                (v.shape[0],) + (1,) * (v.dim() - 1), generator=g) + 0.5
        else:
            out[k] = v.clone()
    return out


def test_load_pwg_checkpoint_matches_jax(tmp_path):
    """A weight-normed pickle in the parallel_wavegan layout (model ->
    generator, with a discriminator and the step count beside it): the
    port's generator and JAX's, with the same noise z, give the same wav."""
    g = torch.Generator().manual_seed(0)
    base = build_vocoder(PWGConfig(**PWG), device="cpu", seed=2)
    sd = _weight_normed(base.state_dict(), g)
    for k in list(sd):
        if k.endswith(".bias"):
            sd[k] = torch.randn(sd[k].shape, generator=g) * 0.1
    path = str(tmp_path / "checkpoint-100steps.pkl")
    torch.save({"model": {"generator": sd, "discriminator": {
        "conv.weight": torch.zeros(2, 2, 3)}}, "steps": 100}, path)

    state = load_pwg_checkpoint(path, PWGConfig(**PWG))
    gen = ParallelWaveGANGenerator(PWGConfig(**PWG))
    gen.load_state_dict(state, strict=True)
    v = state["conv_layers.1.conv.weight"]
    vv = sd["conv_layers.1.conv.weight_v"]
    np.testing.assert_allclose(
        v.flatten(1).norm(dim=1),
        sd["conv_layers.1.conv.weight_g"].flatten(), rtol=1e-5)
    assert torch.allclose(v / v.flatten(1).norm(dim=1)[:, None, None],
                          vv / vv.flatten(1).norm(dim=1)[:, None, None],
                          atol=1e-6)

    jcfg = jax_pwg.PWGConfig(**PWG)
    jvars = jax_pwg.load_pwg_checkpoint(path, jcfg)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, 6, 20)).astype(np.float32)
    z = rng.standard_normal((1, 6 * 64)).astype(np.float32)
    want = np.asarray(jax_pwg.ParallelWaveGANGenerator(jcfg).apply(
        jvars, jnp.asarray(mel), jnp.asarray(z[..., None])))
    with torch.no_grad():
        got = gen(torch.tensor(mel), torch.tensor(z)).numpy()
    assert got.shape == want.shape == (1, 384)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _espnet_dump(tmp_path, model, fe, tokens, token_file: bool):
    """An ESPnet-style experiment of ``model``: config.yaml dumped by PyYAML
    as ESPnet dumps it (indent 4, nested lists, nulls) and a .pth with the
    entries ESPnet's model has beyond A3T's (the front-end's filterbank,
    the normaliser's statistics) under the old ``encoder.embed`` names."""
    import yaml

    out = tmp_path / "espnet_exp"
    espnet.save_espnet_a3t(model, fe, tokens, str(out))
    with open(out / "config.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update({
        "config": "conf/train.yaml", "print_config": False,
        "best_model_criterion": [["valid", "loss", "min"]],
        "keep_nbest_models": 5, "grad_clip": 1.0, "init": None,
        "optim": "adam", "optim_conf": {"lr": 1.0},
        "normalize": "global_mvn",
        "normalize_conf": {"stats_file": "exp/stats/feats_stats.npz"},
        "required": ["output_dir", "token_list"], "version": "0.10.3a1",
    })
    if token_file:
        with open(out / "tokens.txt", "w") as f:
            f.write("\n".join(tokens) + "\n")
        cfg["token_list"] = str(out / "tokens.txt")
    with open(out / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, indent=4, sort_keys=False)
    sd = {k.replace("encoder.speech_embed.", "encoder.embed.", 1): v
          for k, v in model.state_dict().items()}
    sd["feats_extract.logmel.melmat"] = torch.rand(1025, fe.n_mels)
    sd["normalize.mean"] = torch.rand(fe.n_mels)
    sd["normalize.std"] = torch.rand(fe.n_mels)
    path = str(out / "train.loss.ave_5best.pth")
    torch.save({"model": sd}, path)
    return path, sd


def test_espnet_drops_exactly_what_convert_model_state_ignores(exp, tmp_path,
                                                               monkeypatch):
    """convert_model_state run over a dict that records every entry it
    reads: the port keeps exactly those entries."""
    _, exp_dir = exp
    model, cfg, conv = MLMTask.build_model_from_dir(exp_dir, device="cpu")
    _, sd = _espnet_dump(tmp_path, model, cfg.frontend, conv.token_list, False)
    read = set()

    class Recording(dict):
        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    to_np = jax_torch_import._to_np
    monkeypatch.setattr(jax_torch_import, "_to_np",
                        lambda d: Recording(to_np(d)))
    renamed = {k.replace("encoder.embed.", "encoder.speech_embed.", 1): v
               for k, v in sd.items()}
    jax_torch_import.convert_model_state(renamed)
    kept = set(espnet.espnet_state(sd))
    assert kept == read == espnet.espnet_read_keys(renamed)
    dropped = set(renamed) - kept
    assert {"feats_extract.logmel.melmat", "normalize.mean",
            "normalize.std"} <= dropped
    assert all(k.startswith(("feats_extract.", "normalize."))
               or k.endswith("num_batches_tracked") for k in dropped)


@pytest.mark.parametrize("token_file", [False, True])
def test_load_espnet_a3t_matches_jax(exp, tmp_path, token_file):
    _, exp_dir = exp
    model, cfg, conv = MLMTask.build_model_from_dir(exp_dir, device="cpu")
    path, _ = _espnet_dump(tmp_path, model, cfg.frontend, conv.token_list,
                           token_file)
    got_model, got_fe, got_tok = espnet.load_espnet_a3t(path, device="cpu")
    jm, jvars, jfe, jtok = jax_torch_import.load_espnet_a3t(path)
    assert got_tok.token_list == jtok.token_list == conv.token_list
    assert dataclasses.asdict(got_fe) == dataclasses.asdict(jfe)
    assert got_model.config == model.config
    assert not got_model.training
    for k, v in model.state_dict().items():
        assert torch.equal(got_model.state_dict()[k], v), k

    rng = np.random.default_rng(0)
    f, t = 64, 8
    inputs = dict(
        speech=rng.standard_normal((1, f, 20)).astype(np.float32),
        text=rng.integers(0, len(conv), (1, t)),
        masked_position=np.arange(f)[None] % 5 == 0,
        speech_mask=np.arange(f)[None] < 60,
        text_mask=np.arange(t)[None] < 7,
        speech_segment_pos=np.minimum(np.arange(f)[None] // 9 + 1, 7),
        text_segment_pos=np.minimum(np.arange(t)[None] + 1, 7))
    before, after, _ = jm.apply(jvars, **{
        k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
        for k, v in inputs.items()}, train=False)
    with torch.no_grad():
        tb, ta = got_model(**{k: torch.as_tensor(v)
                              for k, v in inputs.items()})
    np.testing.assert_allclose(tb.numpy(), np.asarray(before), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(after), atol=ATOL)


@pytest.mark.parametrize("text,what", [
    ("token_list: &toks [a, b]\n", "anchor"),
    ("note: |\n  a block scalar\n", "block scalar"),
])
def test_espnet_config_outside_the_yaml_subset_raises(tmp_path, text, what):
    (tmp_path / "config.yaml").write_text(text)
    torch.save({}, tmp_path / "m.pth")
    with pytest.raises(ValueError):
        espnet.load_espnet_a3t(str(tmp_path / "m.pth"), device="cpu")


# -- the CLIs ----------------------------------------------------------------

def _sedit_argv(mode, data, exp_dir, uid, new, out, *extra):
    return [mode, "--exp-dir", exp_dir, "--data-dir", data, "--uid", uid,
            "--new-text", new, "--out", out, "--device", "cpu", *extra]


def _requests(data):
    texts = read_2column_text(os.path.join(data, "text"))
    uid = sorted(texts)[1]
    phones = texts[uid].split()
    n = len(phones)
    vocab = sorted({p for t in texts.values() for p in t.split()})
    return uid, phones, {
        # the middle third under [MASK]
        "reconstruct": " ".join(phones[: n // 3] + ["[MASK]"]
                                + phones[-(n // 3):]),
        # 3 phones replaced by 5 vocabulary phones
        "edit": " ".join(phones[:1] + vocab[:5] + phones[4:]),
        # 2 phones and an OOV word (through letter-to-sound) appended
        "prompt": " ".join(phones + vocab[2:4] + ["hello"]),
    }


@pytest.mark.parametrize("mode", ["reconstruct", "edit", "prompt"])
def test_sedit_cli_matches_jax_editor(exp, tmp_path, mode,
                                      jax_letter_to_sound):
    data, exp_dir = exp
    uid, phones, news = _requests(data)
    out = str(tmp_path / f"{mode}.wav")
    res = port_sedit.main(_sedit_argv(mode, data, exp_dir, uid, news[mode],
                                      out))
    assert os.path.isfile(out)

    model, cfg, conv = MLMTask.build_model_from_dir(exp_dir, device="cpu")
    texts = read_2column_text(os.path.join(data, "text"))
    jed = _jax_editor(model, cfg.frontend, conv, jax_letter_to_sound,
                      lexicon=port_sedit.phone_lexicon(texts),
                      duration_fn=lambda ph, w: [0.1] * len(ph))
    wav = A3TDataset(data)[uid]["audio"]
    jalign = JaxFileAlignmentSource(data)(uid)
    old = texts[uid]
    hop = cfg.frontend.hop_length
    if mode == "prompt":
        want = jed.prompt_tts(wav, jalign, old, news[mode])
        np.testing.assert_allclose(res["mel"], want_mel(jed, jalign, wav,
                                                        old, news[mode]),
                                   atol=ATOL)
        assert res["full"].shape == want["full"].shape
        assert res["new_wav"].shape == want["new_wav"].shape
        assert len(res["full"]) > len(wav) and np.isfinite(res["full"]).all()
        return
    fn = jed.reconstruct_masked_span if mode == "reconstruct" else jed.edit
    want = fn(wav, jalign, old, news[mode])
    assert res.old_span_boundary == want.old_span_boundary
    assert res.new_span_boundary == want.new_span_boundary
    np.testing.assert_allclose(res.mel_edited, want.mel_edited, atol=ATOL)
    np.testing.assert_allclose(res.mel_original, want.mel_original,
                               atol=ATOL)
    n_f = res.mel_edited.shape[0]
    assert res.prediction.shape == ((n_f - 1) * hop,)  # Griffin-Lim
    t_old = [hop * x for x in res.old_span_boundary]
    t_new = [hop * x for x in res.new_span_boundary]
    assert len(res.origin_replaced) == \
        len(wav) - (t_old[1] - t_old[0]) + (t_new[1] - t_new[0])


def want_mel(jed, jalign, wav, old, new):
    """JAX's prompt-TTS mel (JAX's prompt_tts returns only the wavs)."""
    tl = jed._new_timeline(wav, jalign, old, new)
    return jed._reconstruct(tl[0], tl[1], tl[2], tl[3], tl[5])


def _pwg_pickle(path, n_mels=20):
    """A parallel_wavegan-layout pickle of the default (24 kHz, hop 300)
    generator on ``n_mels`` bins, weight-normed, from seeded tensors."""
    g = torch.Generator().manual_seed(3)
    sd = _weight_normed(build_vocoder(PWGConfig(aux_channels=n_mels),
                                      device="cpu").state_dict(), g)
    torch.save({"model": {"generator": sd}, "steps": 1}, path)
    return path


def test_sedit_cli_with_pwg_and_dynamic_eval(exp, tmp_path):
    """--vocoder PKL vocodes through the checkpoint's generator (noise from
    a generator seeded with 0: two runs give the same wav); --dynamic-eval
    adapts a copy of the model, so the edit differs from the plain one."""
    data, exp_dir = exp
    uid, _, news = _requests(data)
    pkl = _pwg_pickle(str(tmp_path / "pwg.pkl"))
    argv = lambda name, *x: _sedit_argv(  # noqa: E731
        "edit", data, exp_dir, uid, news["edit"], str(tmp_path / name), *x)
    a = port_sedit.main(argv("a.wav", "--vocoder", pkl))
    b = port_sedit.main(argv("b.wav", "--vocoder", pkl))
    n_f = a.mel_edited.shape[0]
    assert a.prediction.shape == (n_f * 300,)  # PWG: n_f * hop samples
    np.testing.assert_array_equal(a.prediction, b.prediction)
    plain = port_sedit.main(argv("c.wav"))
    np.testing.assert_array_equal(plain.mel_edited, a.mel_edited)
    adapted = port_sedit.main(argv("d.wav", "--dynamic-eval", "1e-2,1"))
    assert adapted.new_span_boundary == plain.new_span_boundary
    assert np.abs(adapted.mel_edited - plain.mel_edited).max() > 1e-4
    assert np.isfinite(adapted.prediction).all()


def test_mcd_gate_cli(exp, tmp_path):
    """--exp-dir and --espnet-ckpt (the same weights written as an ESPnet
    experiment) give the same edited mel bit for bit and MCD.json has JAX's
    keys; the splits are written for ours, the truth and the vocoder."""
    data, exp_dir = exp
    uids = sorted(read_2column_text(os.path.join(data, "text")))[:2]
    out = str(tmp_path / "mcd")
    report = port_mcd_gate.main(["--exp-dir", exp_dir, "--data-dir", data,
                                 "--uids", ",".join(uids), "--out", out,
                                 "--device", "cpu"])
    with open(os.path.join(out, "MCD.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(report))
    assert report["n"] == 2 and np.isfinite(report["mean_mcd"])
    assert np.isfinite(report["vocoder_ceiling_mcd"])
    for prefix in ("sedit", "gt", "vocoder"):
        for split in ("full", "replaced", "unreplaced"):
            for uid in uids:
                assert os.path.isfile(os.path.join(out, prefix, split,
                                                   uid + ".wav"))

    model, cfg, conv = MLMTask.build_model_from_dir(exp_dir, device="cpu")
    jed = _jax_editor(model, cfg.frontend, conv, None,
                      lexicon=port_sedit.phone_lexicon(
                          read_2column_text(os.path.join(data, "text"))))
    from a3t_tpu.bin import mcd_gate as jax_mcd_gate
    from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset

    want = jax_mcd_gate.run_gate(
        jed, read_2column_text(os.path.join(data, "text")),
        JaxA3TDataset(data, jed.tokens), JaxFileAlignmentSource(data), uids,
        str(tmp_path / "jax_mcd"))
    assert set(report) == set(want)
    assert set(report["per_utt"]) == set(want["per_utt"]) == set(uids)
    assert report["protocol"] == want["protocol"]

    esp = _espnet_dump(tmp_path, model, cfg.frontend, conv.token_list,
                       False)[0]
    ed_exp, texts = port_mcd_gate.build_editor(port_argparse(
        exp_dir=exp_dir, data_dir=data))
    ed_esp, _ = port_mcd_gate.build_editor(port_argparse(
        espnet_ckpt=esp, data_dir=data))
    ds = A3TDataset(data, conv)
    align = FileAlignmentSource(data)
    for uid in uids:
        masked = port_mcd_gate.protocol_mask(texts[uid])
        r1 = ed_exp.reconstruct_masked_span(ds[uid]["audio"], align(uid),
                                            texts[uid], masked)
        r2 = ed_esp.reconstruct_masked_span(ds[uid]["audio"], align(uid),
                                            texts[uid], masked)
        np.testing.assert_array_equal(r1.mel_edited, r2.mel_edited)


def port_argparse(**kw):
    import argparse

    base = dict(exp_dir=None, espnet_ckpt=None, checkpoint="ave",
                vocoder=None, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def _cli_argv(cli, exp, tmp_path, *extra):
    data, exp_dir = exp
    if cli == "sedit":
        return port_sedit.main, _sedit_argv(
            "edit", data, exp_dir, "utt000", "AA", str(tmp_path / "o.wav"),
            *extra)
    return port_mcd_gate.main, ["--exp-dir", exp_dir, "--data-dir", data,
                                "--out", str(tmp_path / "m"), "--device",
                                "cpu", *extra]


@pytest.mark.parametrize("cli", ["sedit", "mcd_gate"])
@pytest.mark.parametrize("flag,item", [("--vocoder", "A2")])
def test_unported_options_raise(exp, tmp_path, cli, flag, item):
    main, argv = _cli_argv(cli, exp, tmp_path, flag, str(tmp_path))
    with pytest.raises(NotImplementedError, match=item):
        main(argv)
    assert not os.path.exists(tmp_path / "o.wav")
    assert not os.path.exists(tmp_path / "m")


@pytest.mark.parametrize("cli", ["sedit", "mcd_gate"])
@pytest.mark.parametrize("extra,error", [
    (("--spk-xvector", "x.npy"), ValueError),
    (("--duration-model", "missing.pth"), FileNotFoundError)])
def test_duration_options_check_their_inputs(exp, tmp_path, cli, extra,
                                             error):
    """--spk-xvector alone (it conditions the duration model) and a
    --duration-model that is not there raise before anything is written
    (tests/test_torch_fs2_serve.py runs both options against JAX)."""
    main, argv = _cli_argv(cli, exp, tmp_path, *extra)
    with pytest.raises(error):
        main(argv)
    assert not os.path.exists(tmp_path / "o.wav")
    assert not os.path.exists(tmp_path / "m")


def test_clis_need_cuda_unless_asked_for_cpu(exp, tmp_path, monkeypatch):
    data, exp_dir = exp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _sedit_argv("edit", data, exp_dir, "utt000", "AA",
                       str(tmp_path / "o.wav"))[:-2]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            port_sedit.main(argv + extra)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_mcd_gate.main(["--exp-dir", exp_dir, "--data-dir", data,
                                "--out", str(tmp_path / "m"), *extra])
    assert not os.path.exists(tmp_path / "o.wav")
