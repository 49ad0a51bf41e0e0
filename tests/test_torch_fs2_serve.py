"""FastSpeech2 training, loading and serving in the port
(a3t_tpu_torch/tasks/fs2.py, compat/fs2.py, compat/from_jax.py::fs2_state,
inference/durations.py, inference/baselines.py::FS2Baselines,
bin/batch_decode.py and the --duration-model / --spk-xvector options of
bin/sedit.py and bin/mcd_gate.py) against the JAX package on the CPU.

The FS2 experiment is written by the port's ``FS2Task.run`` (2 steps of
configs/fs2_conformer_24k.yaml cut to width 16, 1 + 1 blocks, 20 mel bins,
GST and 4-dim x-vectors) on the mini corpus of test_torch_serve_cli.py,
whose ``exp`` fixture trains the A3T experiment beside it.  Two steps leave
the duration predictor near its init, whose durations round to 0-1 frames;
the fixture sets its output bias to log(4) in the saved checkpoints, so
phones last about 3 frames.  JAX reads the port's experiments through its
own converters (``convert_model_state``, ``convert_fs2_state``), patched in
as its ``build_model_from_dir``; the port's Griffin-Lim starts from JAX's
``PRNGKey(0)`` phase.

Tolerances (fp32): durations equal, except within 1e-5 of a .5 in
exp(log_d) - 1 (as test_torch_fs2.py); mels atol 1e-4, the mels each
package hands its vocoder included; the ESPnet and the experiment routes
bit for bit.  The baselines' wavs through Griffin-Lim within 1e-3 of their
largest sample (read 4e-6 to 3.9e-4).  The CLIs' wavs are held by the mels
they vocode and their lengths: from the untrained models' mels, 32 phase
iterations grow the mels' 1e-5 differences to 0.2-2.8% of the largest
sample (tests/test_torch_griffin_lim.py holds Griffin-Lim itself from one
mel).  MCD within 1e-2 dB (read up to 6e-4; an utterance whose span is
empty scores NaN in both packages).
"""

import argparse
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.bin import batch_decode as jax_batch_decode
from a3t_tpu.bin import mcd_gate as jax_mcd_gate
from a3t_tpu.bin import sedit as jax_sedit_cli
from a3t_tpu.compat import fs2_import as jax_fs2_import
from a3t_tpu.compat.torch_import import convert_model_state
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.inference import FileAlignmentSource as JaxFileAlignmentSource
from a3t_tpu.inference import baselines as jax_baselines
from a3t_tpu.inference import durations as jax_durations
from a3t_tpu.models import A3TMLMModel as JaxA3TMLMModel
from a3t_tpu.models import fastspeech2 as jax_fs2
from a3t_tpu.tasks import config as jax_task_config
from a3t_tpu.tasks import fs2 as jax_fs2_task
from a3t_tpu.tasks.mlm import MLMTask as JaxMLMTask
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu_torch.bin import batch_decode as port_batch_decode
from a3t_tpu_torch.bin import mcd_gate as port_mcd_gate
from a3t_tpu_torch.bin import sedit as port_sedit
from a3t_tpu_torch.compat import fs2 as port_compat_fs2
from a3t_tpu_torch.compat.from_jax import fs2_state
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text, read_wav
from a3t_tpu_torch.dsp import LogMelFrontend, griffin_lim, mel_to_linear
from a3t_tpu_torch.inference import FileAlignmentSource, FS2Baselines
from a3t_tpu_torch.inference import baselines as port_baselines
from a3t_tpu_torch.inference import sedit as port_sedit_inference
from a3t_tpu_torch.inference.durations import load_duration_fn
from a3t_tpu_torch.models.fastspeech2 import build_fs2
from a3t_tpu_torch.tasks.fs2 import FS2Task, load_fs2_config
from a3t_tpu_torch.tasks.mlm import MLMTask
from test_torch_fs2 import assert_durations_match, jax_fs2_config
from test_torch_serve_cli import _jax_config, exp  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS2_CONFIG = os.path.join(ROOT, "configs", "fs2_conformer_24k.yaml")
ATOL = 1e-4
TOL_WAV = 1e-3
SPK_DIM = 4


def _fs2_sets(data, exp_dir, spk):
    sets = [f"train_data_dir={data}", f"valid_data_dir={data}",
            f"exp_dir={exp_dir}", f"spk_xvector={spk}", "frontend.n_mels=20",
            "model.adim=16", "model.postnet_layers=1", "model.postnet_chans=8",
            "model.gst_heads=2", "model.gst_conv_chans_list=[4,4,8]",
            "model.gst_gru_units=8", f"model.spk_embed_dim={SPK_DIM}",
            "model.max_feat_len=192", "batcher.max_feat_len=192",
            "batcher.batch_size=2", "batcher.text_buckets=[16]",
            "trainer.max_epoch=1", "trainer.num_iters_per_epoch=2"]
    for name in ("duration", "pitch", "energy"):
        sets.append(f"model.{name}_predictor_chans=8")
    return sets + [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
                   for k, v in (("attention_dim", 16), ("linear_units", 16),
                                ("num_blocks", 1))]


@pytest.fixture(scope="module")
def fs2_exp(exp, tmp_path_factory):  # noqa: F811
    """(data dir, A3T experiment, FS2 experiment, spk2xvector path, its
    x-vectors, the trainer, the final state)."""
    data, a3t_exp = exp
    root = tmp_path_factory.mktemp("fs2serve")
    rng = np.random.default_rng(11)
    spk2xv = {f"spk{i}": rng.standard_normal(SPK_DIM).astype(np.float32)
              for i in range(3)}
    spk = str(root / "spk2xvector.npz")
    np.savez(spk, **spk2xv)
    cfg = load_fs2_config(FS2_CONFIG, _fs2_sets(data, str(root / "fs2"), spk))
    trainer, state = FS2Task.run(cfg, device="cpu")
    ckpt = os.path.join(cfg.exp_dir, "checkpoints")
    for name in os.listdir(ckpt):
        if name.endswith(".pt"):
            tree = torch.load(os.path.join(ckpt, name), weights_only=True)
            inner = tree["params"] if "params" in tree else tree["model"]
            inner["duration_predictor.linear.bias"].fill_(float(np.log(4.0)))
            torch.save(tree, os.path.join(ckpt, name))
    return data, a3t_exp, cfg.exp_dir, spk, spk2xv, trainer, state


def jax_fs2_from_port(model):
    """(JAX FastSpeech2, variables) of a port FastSpeech2, through JAX's
    own converter of ESPnet state dicts."""
    variables = jax_fs2_import.convert_fs2_state(
        {k: v.detach().numpy() for k, v in model.state_dict().items()})
    return jax_fs2.FastSpeech2(jax_fs2_config(model.config)), variables


def _jax_cfg(cfg):
    return types.SimpleNamespace(frontend=JaxLogMelConfig(
        **dataclasses.asdict(cfg.frontend)))


@pytest.fixture
def jax_reads_port_experiments(monkeypatch):
    """JAX's MLMTask / FS2Task.build_model_from_dir reading the port's
    experiments (JAX cannot read torch checkpoints) through its own
    converters."""
    def mlm(exp_dir, which="ave"):
        model, cfg, conv = MLMTask.build_model_from_dir(exp_dir, which,
                                                        device="cpu")
        return (JaxA3TMLMModel(_jax_config(model.config)),
                convert_model_state(model.state_dict()), _jax_cfg(cfg),
                JaxTokenIDConverter(conv.token_list))

    def fs2(exp_dir, which="ave"):
        model, cfg, conv = FS2Task.build_model_from_dir(exp_dir, which,
                                                        device="cpu")
        jm, v = jax_fs2_from_port(model)
        return jm, v, _jax_cfg(cfg), JaxTokenIDConverter(conv.token_list)

    monkeypatch.setattr(JaxMLMTask, "build_model_from_dir",
                        staticmethod(mlm))
    monkeypatch.setattr(jax_fs2_task.FS2Task, "build_model_from_dir",
                        staticmethod(fs2))


@pytest.fixture
def jax_phase(monkeypatch):
    """The port's Griffin-Lim (editor and baselines) from the phase JAX's
    draws from PRNGKey(0); returns the lists of mels that each package
    hands its vocoder, in order."""
    import a3t_tpu.dsp.griffin_lim as jax_gl

    seen = {"port": [], "jax": []}

    def logmel_to_wav(m, config, n_iters=32, seed=0):
        seen["port"].append(m[0].numpy().copy())
        mag = mel_to_linear(m, config)
        phase = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(mag.shape), jnp.float32, -np.pi,
            np.pi))
        return griffin_lim(mag, config, n_iters, phase=torch.tensor(phase))

    jax_logmel_to_wav = jax_gl.logmel_to_wav

    def jax_vocoder(m, config, *a):
        seen["jax"].append(np.asarray(m)[0].copy())
        return jax_logmel_to_wav(m, config, *a)

    monkeypatch.setattr(port_baselines, "logmel_to_wav", logmel_to_wav)
    monkeypatch.setattr(port_sedit_inference, "logmel_to_wav", logmel_to_wav)
    monkeypatch.setattr(jax_gl, "logmel_to_wav", jax_vocoder)
    return seen


def _wav_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_WAV * np.abs(want).max()


def _vocoded_alike(seen, n):
    """The ``n`` mels each package vocoded equal within the tolerance."""
    assert len(seen["port"]) == len(seen["jax"]) == n
    for a, b in zip(seen["port"], seen["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)


# -- training, the experiment and the state maps ------------------------------------

def test_fs2_task_run_and_build_model_from_dir(fs2_exp):
    """Two finite steps (the trainer's step log), the experiment's files,
    a config both packages' loaders read, and build_model_from_dir: the
    n-best average's parameters with the epoch's BatchNorm statistics."""
    _, _, exp_dir, _, _, trainer, state = fs2_exp
    log = list(trainer.step_log)
    assert len(log) == 2 and all(np.isfinite(r["loss"]) for r in log)
    assert all(r["batch"] == 2 and r["frames"] == 192 for r in log)
    assert state.step == 2
    names = sorted(os.listdir(os.path.join(exp_dir, "checkpoints")))
    assert "epoch_1.pt" in names and any(n.startswith("ave_") for n in names)
    cfg = load_fs2_config(os.path.join(exp_dir, "config.yaml"))
    jcfg = jax_task_config._build(
        jax_fs2_task.FS2TaskConfig,
        jax_task_config.load_yaml_dict(os.path.join(exp_dir, "config.yaml")))
    assert jcfg.model.spk_embed_dim == cfg.model.spk_embed_dim == SPK_DIM
    assert jcfg.batcher.text_buckets == cfg.batcher.text_buckets == (16,)
    model, cfg2, conv = FS2Task.build_model_from_dir(exp_dir, device="cpu")
    assert cfg2 == cfg and not model.training
    assert model.config.idim == len(conv) + 1
    epoch = torch.load(os.path.join(exp_dir, "checkpoints", "epoch_1.pt"),
                       weights_only=True)["model"]
    got = model.state_dict()
    for k in ("postnet.postnet.0.1.running_mean",
              "encoder.encoders.0.conv_module.norm.running_var"):
        assert torch.equal(got[k], epoch[k])
    assert float(got["duration_predictor.linear.bias"]) == pytest.approx(
        np.log(4.0))


def test_fs2_state_round_trip(fs2_exp):
    """port state -> JAX's convert_fs2_state -> fs2_state gives the state
    back bit for bit, for the trained conformer form and a transformer form
    (ESPnet's norm1/norm2 there, renamed by compat/fs2.py)."""
    _, _, exp_dir, _, _, _, _ = fs2_exp
    model, _, _ = FS2Task.build_model_from_dir(exp_dir, device="cpu")
    cfg = dataclasses.replace(
        model.config, encoder_conformer=False,
        encoder=jax_fs2.transformer_stack_config(16, 2, 1, 16),
        decoder=jax_fs2.transformer_stack_config(16, 2, 1, 16))
    from test_torch_fs2 import port_stack

    other = build_fs2(dataclasses.replace(
        cfg, encoder=port_stack(cfg.encoder), decoder=port_stack(cfg.decoder)),
        device="cpu", seed=3)
    for m in (model, other):
        sd = {k: v.numpy() for k, v in m.state_dict().items()}
        espnet = port_compat_fs2._rename_norms(
            sd, {"norm_mha": "norm1", "norm_ff": "norm2"}) \
            if not m.config.encoder_conformer else sd
        back = {k: v for k, v in fs2_state(
            jax_fs2_import.convert_fs2_state(espnet)).items()
            if not k.endswith("num_batches_tracked")}
        want = {k: v for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}
        assert set(back) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_save_espnet_fs2_loads_in_jax_and_port(fs2_exp, tmp_path):
    """save_espnet_fs2 writes a tts.-prefixed .pth and a config.yaml that
    JAX's load_espnet_fs2 reads (its forward and durations match the
    port's) and the port's reads back bit for bit (strict)."""
    data, _, exp_dir, _, spk2xv, _, _ = fs2_exp
    model, cfg, conv = FS2Task.build_model_from_dir(exp_dir, device="cpu")
    pth = port_compat_fs2.save_espnet_fs2(model, conv.token_list,
                                          cfg.frontend, str(tmp_path / "e"))
    assert all(k.startswith("tts.") for k in
               torch.load(pth, weights_only=True))
    back, tokens = port_compat_fs2.load_espnet_fs2(pth, device="cpu")
    assert tokens == conv.token_list + ["<eos>"]
    sd = model.state_dict()
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jm, jv, jtokens = jax_fs2_import.load_espnet_fs2(pth)
    assert list(jtokens) == tokens
    rng = np.random.default_rng(2)
    text = rng.integers(1, len(conv), (1, 9))
    mask = np.ones((1, 9), bool)
    speech = rng.standard_normal((1, 40, 20)).astype(np.float32)
    sp = spk2xv["spk1"][None]
    want = jm.apply(jv, jnp.asarray(text, jnp.int32), jnp.asarray(mask),
                    speech=jnp.asarray(speech), spembs=jnp.asarray(sp))
    with torch.no_grad():
        got = back(torch.tensor(text), torch.tensor(mask),
                   speech=torch.tensor(speech), spembs=torch.tensor(sp))
    np.testing.assert_allclose(got["log_duration"].numpy(),
                               np.asarray(want["log_duration"]), atol=1e-5)
    assert_durations_match(got["durations"].numpy(), want["durations"],
                           want["log_duration"])
    if np.array_equal(got["durations"].numpy(), want["durations"]):
        np.testing.assert_allclose(got["after"].numpy(),
                                   np.asarray(want["after"]), atol=ATOL)


def test_transformer_espnet_round_trip(tmp_path):
    """The transformer form (scaled positions, ESPnet's norm1/norm2)
    through save_espnet_fs2 -> JAX's and the port's load_espnet_fs2."""
    from test_torch_fs2 import port_fs2_config, tiny_fs2_config

    cfg = port_fs2_config(tiny_fs2_config(False))
    model = build_fs2(cfg, device="cpu", seed=4)
    with torch.no_grad():
        model.encoder.embed[1].alpha.fill_(0.8)
    tokens = ["<blank>", "<unk>"] + [f"P{i}" for i in range(17)] + ["<sos/eos>"]
    fe = port_compat_fs2.LogMelConfig(n_mels=16)
    pth = port_compat_fs2.save_espnet_fs2(model, tokens, fe,
                                          str(tmp_path / "t"))
    sd = torch.load(pth, weights_only=True)
    assert "tts.encoder.encoders.0.norm1.weight" in sd
    assert "tts.encoder.embed.1.alpha" in sd
    back, _ = port_compat_fs2.load_espnet_fs2(pth, device="cpu")
    for k, v in back.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    jm, jv, _ = jax_fs2_import.load_espnet_fs2(pth)
    assert float(jv["params"]["enc_posenc"]["alpha"]) == pytest.approx(0.8)
    text = np.arange(1, 8)[None]
    with torch.no_grad():
        hs = back.encode_hidden(torch.tensor(text),
                                torch.ones(1, 7, dtype=torch.bool))
    want = jm.apply(jv, jnp.asarray(text, jnp.int32), jnp.ones((1, 7), bool),
                    method="encode_hidden")
    np.testing.assert_allclose(hs.numpy(), np.asarray(want), atol=1e-5)


# -- the duration function ---------------------------------------------------------

def test_load_duration_fn_routes_match_jax(fs2_exp, tmp_path):
    """The experiment route and the ESPnet .pth route of the same weights
    give the same seconds bit for bit (twice each); JAX's ESPnet route
    gives the same seconds, up to roundings within 1e-5 of a .5; "sp" maps
    to <unk> (experiment) and <blank> (ESPnet); the eos is dropped."""
    data, _, exp_dir, _, spk2xv, _, _ = fs2_exp
    model, cfg, conv = FS2Task.build_model_from_dir(exp_dir, device="cpu")
    pth = port_compat_fs2.save_espnet_fs2(model, conv.token_list,
                                          cfg.frontend, str(tmp_path / "e"))
    sp = spk2xv["spk2"]
    by_dir = load_duration_fn(exp_dir, spembs=sp, device="cpu")
    by_pth = load_duration_fn(pth, spembs=sp, device="cpu")
    jax_fn = jax_durations.load_duration_fn(pth, spembs=sp)
    texts = read_2column_text(os.path.join(data, "text"))
    ds = A3TDataset(data)
    fe = LogMelFrontend(cfg.frontend, device="cpu")
    for uid in sorted(texts)[:2]:
        phones = texts[uid].split()
        wav = ds[uid]["audio"]
        a = by_dir(phones, wav)
        assert a == by_dir(phones, wav) == by_pth(phones, wav)
        assert len(a) == len(phones) and sum(a) > 0
        want = jax_fn(phones, wav)
        ids = conv.tokens2ids(phones) + [len(conv)]
        with torch.no_grad():
            hs = model.encode_hidden(
                torch.tensor([ids]), torch.ones(1, len(ids), dtype=torch.bool),
                fe(wav[None])[0], torch.tensor(sp[None]))
            log_d = model.duration_predictor(hs)[0, :-1].numpy()
        hop_s = cfg.frontend.hop_length / cfg.frontend.fs
        assert_durations_match(np.round(np.array(a) / hop_s),
                               np.round(np.array(want) / hop_s), log_d)
    with_sp = ["sp"] + texts[sorted(texts)[0]].split()
    assert len(by_dir(with_sp, wav)) == len(with_sp)


# -- the baselines -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mask"])
def test_baselines_match_jax(fs2_exp, jax_phase, mode):
    """baseline1/2/3 against JAX's FS2Baselines on the same weights, both
    vocoded by Griffin-Lim from JAX's PRNGKey(0) phase, for a [MASK]
    reconstruction (a text replacement goes through
    test_batch_decode_matches_jax_cli)."""
    data, _, exp_dir, _, spk2xv, _, _ = fs2_exp
    model, cfg, conv = FS2Task.build_model_from_dir(exp_dir, device="cpu")
    jm, jv = jax_fs2_from_port(model)
    texts = read_2column_text(os.path.join(data, "text"))
    uid = sorted(texts)[1]
    old = texts[uid]
    phones = old.split()
    vocab = sorted({p for t in texts.values() for p in t.split()})
    new = (" ".join(phones[:1] + vocab[:3] + phones[3:]) if mode == "edit"
           else port_mcd_gate.protocol_mask(old))
    lexicon = port_sedit.phone_lexicon(texts)
    wav = A3TDataset(data)[uid]["audio"]
    align = FileAlignmentSource(data)(uid)
    jalign = JaxFileAlignmentSource(data)(uid)
    fe = LogMelFrontend(cfg.frontend, device="cpu")
    jfe = JaxLogMelFrontend(JaxLogMelConfig(**dataclasses.asdict(
        cfg.frontend)))
    hop = cfg.frontend.hop_length

    def mel(w):
        return fe(w[None])[0][0, :1 + len(w) // hop].numpy()

    def jmel(w):
        return np.asarray(jfe(jnp.asarray(w[None]))[0])[0, :1 + len(w) // hop]

    port_b = FS2Baselines(model, conv, fe)
    jax_b = jax_baselines.FS2Baselines(jm, jv, JaxTokenIDConverter(
        conv.token_list), jfe)
    sp = spk2xv["spk0"]
    resolved = port_baselines.resolve_mask_str(align, old, new, lexicon)
    _wav_close(port_b.baseline1(resolved, wav, sp),
               jax_b.baseline1(resolved, wav, sp))
    target = " ".join(vocab[:3]) if mode == "edit" else resolved
    _wav_close(port_b.baseline2(wav, align, old, new, target, lexicon, mel,
                                sp),
               jax_b.baseline2(wav, jalign, old, new, target, lexicon, jmel,
                               sp))
    _wav_close(port_b.baseline3(wav, align, old, new, lexicon, mel, sp),
               jax_b.baseline3(wav, jalign, old, new, lexicon, jmel, sp))


# -- the CLIs -------------------------------------------------------------------------

def test_batch_decode_matches_jax_cli(fs2_exp, tmp_path, jax_phase,
                                      jax_reads_port_experiments):
    """bin.batch_decode --fs2-exp --spk-xvector against JAX's CLI on the
    same task file (a text replacement; the [MASK] protocol's baselines go
    through test_baselines_match_jax): the mels the six wavs come from, the
    wavs' lengths, the ground-truth span bit for bit."""
    data, a3t_exp, exp_dir, spk, _, _, _ = fs2_exp
    texts = read_2column_text(os.path.join(data, "text"))
    u1 = sorted(texts)[0]
    vocab = sorted({p for t in texts.values() for p in t.split()})
    p1 = texts[u1].split()
    task = tmp_path / "tasks.txt"
    task.write_text(f"{u1}|{' '.join(p1[:2] + vocab[:2] + p1[3:])}\n")
    argv = ["--exp-dir", a3t_exp, "--data-dir", data, "--task-file",
            str(task), "--fs2-exp", exp_dir, "--spk-xvector", spk]
    got = port_batch_decode.main(argv + ["--out-dir", str(tmp_path / "p"),
                                         "--device", "cpu"])
    jax_batch_decode.main(argv + ["--out-dir", str(tmp_path / "j")])
    names = ("full", "replaced", "gt_span", "baseline1", "baseline2",
             "baseline3")
    assert set(got) == {u1}
    # the edit's mel, then baseline1, 2, 3
    _vocoded_alike(jax_phase, 4)
    for uid in (u1,):
        assert set(got[uid]) == set(names)
        for name in names:
            fs, ours = read_wav(str(tmp_path / "p" / f"{uid}_{name}.wav"))
            _, theirs = read_wav(str(tmp_path / "j" / f"{uid}_{name}.wav"))
            assert fs == 24000 and np.isfinite(ours).all()
            assert ours.shape == theirs.shape, (uid, name)
            if name == "gt_span":
                np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("route", ["pth"])
def test_sedit_duration_model_matches_jax_cli(fs2_exp, tmp_path, jax_phase,
                                              jax_reads_port_experiments,
                                              route):
    """bin.sedit edit --duration-model (the FS2 experiment's ESPnet .pth;
    the experiment's own route gives the same durations bit for bit,
    test_load_duration_fn_routes_match_jax, and runs in
    test_mcd_gate_duration_model_matches_jax) --spk-xvector against JAX's
    CLI: the timeline's spans equal, the edited mel within atol 1e-4, the
    vocoded mels alike and the wavs of one length."""
    data, a3t_exp, exp_dir, _, spk2xv, _, _ = fs2_exp
    spk = str(tmp_path / "spk1.npy")
    np.save(spk, spk2xv["spk1"])
    dur = exp_dir
    if route == "pth":
        model, cfg, conv = FS2Task.build_model_from_dir(exp_dir, device="cpu")
        dur = port_compat_fs2.save_espnet_fs2(model, conv.token_list,
                                              cfg.frontend,
                                              str(tmp_path / "e"))
    texts = read_2column_text(os.path.join(data, "text"))
    uid = sorted(texts)[1]
    phones = texts[uid].split()
    vocab = sorted({p for t in texts.values() for p in t.split()})
    new = " ".join(phones[:2] + vocab[:4] + phones[3:])
    argv = ["edit", "--exp-dir", a3t_exp, "--data-dir", data, "--uid", uid,
            "--new-text", new, "--duration-model", dur, "--spk-xvector",
            spk]
    res = port_sedit.main(argv + ["--out", str(tmp_path / "p.wav"),
                                  "--device", "cpu"])
    jax_sedit_cli.main(argv + ["--out", str(tmp_path / "j.wav")])
    ns = argparse.Namespace(exp_dir=a3t_exp, data_dir=data, checkpoint="ave",
                            vocoder=None, duration_model=dur,
                            spk_xvector=spk, uniform_duration=0.1)
    jed, jalign, _, _ = jax_sedit_cli.build_editor(ns)
    want = jed.edit(A3TDataset(data)[uid]["audio"], jalign(uid), texts[uid],
                    new)
    assert res.old_span_boundary == want.old_span_boundary
    assert res.new_span_boundary == want.new_span_boundary
    np.testing.assert_allclose(res.mel_edited, want.mel_edited, atol=ATOL)
    # one vocoded mel each from the CLIs (JAX's build_editor's edit after)
    np.testing.assert_allclose(jax_phase["port"][0], jax_phase["jax"][0],
                               atol=ATOL)
    assert read_wav(str(tmp_path / "p.wav"))[1].shape == \
        read_wav(str(tmp_path / "j.wav"))[1].shape
    plain = port_sedit.main(["edit", "--exp-dir", a3t_exp, "--data-dir",
                             data, "--uid", uid, "--new-text", new, "--out",
                             str(tmp_path / "u.wav"), "--device", "cpu"])
    assert plain.new_span_boundary != res.new_span_boundary


def test_mcd_gate_duration_model_matches_jax(fs2_exp, tmp_path, jax_phase,
                                             jax_reads_port_experiments):
    """bin.mcd_gate --duration-model --spk-xvector: the masked spans are
    regenerated at the predicted durations (not the original timeline), as
    JAX's gate does; per-utterance MCD within 1e-2 dB of JAX's."""
    data, a3t_exp, exp_dir, _, spk2xv, _, _ = fs2_exp
    spk = str(tmp_path / "spk0.npy")
    np.save(spk, spk2xv["spk0"])
    uids = sorted(read_2column_text(os.path.join(data, "text")))[:1]
    argv = ["--exp-dir", a3t_exp, "--data-dir", data, "--uids",
            ",".join(uids), "--duration-model", exp_dir, "--spk-xvector",
            spk]
    report = port_mcd_gate.main(argv + ["--out", str(tmp_path / "p"),
                                        "--device", "cpu"])
    jax_mcd_gate.main(argv + ["--out", str(tmp_path / "j")])
    import json

    with open(tmp_path / "j" / "MCD.json") as f:
        want = json.load(f)
    assert report["n"] == want["n"] == 1
    # the edit's mel, then the unedited one (the ceiling)
    _vocoded_alike(jax_phase, 2)
    for key in ("per_utt", "per_utt_vocoder"):
        for uid in uids:
            assert report[key][uid] == pytest.approx(
                want[key][uid], abs=1e-2, nan_ok=True)


def test_spk_xvector_needs_the_duration_model(fs2_exp, tmp_path):
    """--spk-xvector conditions the duration model: alone it raises before
    anything is written (the JAX CLI ignores it there)."""
    data, a3t_exp, _, _, _, _, _ = fs2_exp
    uid = sorted(read_2column_text(os.path.join(data, "text")))[0]
    with pytest.raises(ValueError, match="--duration-model"):
        port_sedit.main(["edit", "--exp-dir", a3t_exp, "--data-dir", data,
                         "--uid", uid, "--new-text", "AA", "--out",
                         str(tmp_path / "o.wav"), "--device", "cpu",
                         "--spk-xvector", "x.npy"])
    assert not os.path.exists(tmp_path / "o.wav")
