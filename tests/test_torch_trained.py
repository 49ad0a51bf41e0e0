"""The JAX package's trained checkpoints read by the port without orbax
(a3t_tpu_torch/compat/orbax.py), against the JAX package reading them with
orbax.

* Edit parity: one edit of a 16 kHz utterance with the trained stash
  (``artifacts/soak12k_params``, read by the port's ``restore_portable``)
  and the trained vocoder (``artifacts/vocoder``, read by the port's
  ``load_vocoder``) equals JAX's edit (JAX's ``restore_portable`` and
  ``load_vocoder``).  Both sides run in fp32 (the stash's bf16 compute
  overridden, as in tests/test_torch_stash.py) and the port's vocoder takes
  JAX's own noise.  Measured on the CPU: mel max-abs difference 1.06e-5
  of its largest magnitude (bound 1e-4), wav 1.75e-4 of its largest sample
  (bound 1e-3).
* Warm start: ``warm_start_params`` from the stash, with and without
  ``grow_vocab``, equals ``mlm_state`` of JAX's warm-started params bit for
  bit (the fresh rows included: both models start from JAX's init).
* JAX experiment directories: an MLM and an FS2 experiment whose
  ``checkpoints/`` hold ``epoch_1``, ``epoch_2`` and ``ave_2best`` written
  by orbax from JAX's init variables give the port's
  ``build_model_from_dir`` the state ``mlm_state``/``fs2_state`` gives of
  JAX's ``build_model_from_dir`` variables, bit for bit, for ``which`` in
  ave, latest and epoch_1.
* The trained vocoder's generator read from ``artifacts/vocoder`` equals
  the port's converted copy ``a3t_tpu_torch/weights/vocoder_16k`` bit for
  bit."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3t_tpu_torch.compat.from_jax import fs2_state, mlm_state
from a3t_tpu_torch.compat.orbax import restore_portable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STASH = os.path.join(ROOT, "artifacts", "soak12k_params")
VOCODER = os.path.join(ROOT, "artifacts", "vocoder")
MEL_TOL, WAV_TOL = 1e-4, 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dummy(n_frames=64, n_text=8, odim=80):
    return dict(speech=jnp.zeros((1, n_frames, odim)),
                text=jnp.zeros((1, n_text), jnp.int32),
                masked_position=jnp.zeros((1, n_frames), bool),
                speech_mask=jnp.ones((1, n_frames), bool),
                text_mask=jnp.ones((1, n_text), bool),
                speech_segment_pos=jnp.zeros((1, n_frames), jnp.int32),
                text_segment_pos=jnp.zeros((1, n_text), jnp.int32))


def _fp32(model_cfg, vocab):
    return dataclasses.replace(
        model_cfg, vocab_size=vocab,
        encoder=dataclasses.replace(model_cfg.encoder,
                                    compute_dtype="float32"),
        decoder=dataclasses.replace(model_cfg.decoder,
                                    compute_dtype="float32"))


@pytest.fixture(scope="module")
def stash():
    """(JAX task config, its fp32 model config, JAX's fp32 init variables)
    at the stash's widths and vocabulary."""
    from a3t_tpu.models import A3TMLMModel
    from a3t_tpu.tasks.config import load_config

    cfg = load_config(os.path.join(STASH, "config.yaml"))
    assert cfg.model.encoder.compute_dtype == "bfloat16"
    vocab = restore_portable(STASH)["params"]["text_embed"][
        "embedding"].shape[0]
    model_cfg = _fp32(cfg.model, vocab)
    init = _np_tree(jax.jit(A3TMLMModel(model_cfg).init)(
        jax.random.PRNGKey(0), **_dummy()))
    return cfg, model_cfg, init


def _port_model(model_cfg, variables):
    from a3t_tpu_torch.compat.from_jax import load_state
    from a3t_tpu_torch.models import build_model
    from test_torch_mlm import port_config

    model = build_model(port_config(model_cfg), device="cpu")
    load_state(model, mlm_state(variables))
    return model.eval()


def test_trained_edit_matches_jax(stash):
    from a3t_tpu.inference import SpeechEditor as JaxSpeechEditor
    from a3t_tpu.inference import UtteranceAlignment as JaxAlignment
    from a3t_tpu.models import A3TMLMModel
    from a3t_tpu.text import TokenIDConverter as JaxTokens
    from a3t_tpu.train.checkpoint import restore_portable as jax_restore
    from a3t_tpu.train.vocoder import load_vocoder as jax_load_vocoder
    from a3t_tpu_torch.dsp import LogMelConfig
    from a3t_tpu_torch.inference import SpeechEditor, UtteranceAlignment
    from a3t_tpu_torch.text import TokenIDConverter
    from a3t_tpu_torch.train.vocoder import load_vocoder

    cfg, model_cfg, init = stash
    stats = init["batch_stats"]  # the stash holds no statistics
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(np.float32),
        jax_restore(STASH)["params"])
    tree = restore_portable(STASH)
    model = _port_model(model_cfg, {"params": tree["params"],
                                    "batch_stats": stats})

    with open(os.path.join(STASH, "tokens.txt")) as f:
        tokens = [t.strip() for t in f if t.strip()]
    phones = [tokens[2 + (5 * i) % (len(tokens) - 3)] for i in range(16)]
    fs = cfg.frontend.fs
    t = np.arange(int(1.6 * fs)) / fs
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.5 * t)
    wav = sum(np.sin(2 * np.pi * np.cumsum(f0 * k) / fs) / k
              for k in range(1, 6)) * 0.1
    wav = (wav + 0.003 * np.random.default_rng(0).standard_normal(
        t.size)).astype(np.float32)
    bounds = np.linspace(0, 1.6, len(phones) + 1)
    w2p = {f"{i}_{p}": [p] for i, p in enumerate(phones)}
    lexicon = {p: [p] for p in tokens[2:-1]}
    durations = lambda ph, w: [0.1] * len(ph)  # noqa: E731
    old = " ".join(phones)
    new = " ".join(phones[:6] + ["M", "IY", "S"] + phones[10:])

    jvocode = jax_load_vocoder(VOCODER)
    hop = cfg.frontend.hop_length

    def jax_noise(n_frames):
        n_pad = -(-n_frames // 64) * 64
        return np.array(jax.random.normal(
            jax.random.PRNGKey(0), (1, n_pad * hop, 1)))[..., 0]

    pvocode = load_vocoder(VOCODER, device="cpu")
    jed = JaxSpeechEditor(
        A3TMLMModel(model_cfg), {"params": jparams, "batch_stats": stats},
        cfg.frontend, JaxTokens(tokens), vocoder=jvocode,
        duration_fn=durations, lexicon=lexicon)
    ped = SpeechEditor(
        model, LogMelConfig(**dataclasses.asdict(cfg.frontend)),
        TokenIDConverter(tokens),
        vocoder=lambda m: pvocode(m, z=jax_noise(m.shape[1])),
        duration_fn=durations, lexicon=lexicon, device="cpu")
    want = jed.edit(wav, JaxAlignment(phones, bounds[:-1], bounds[1:], w2p),
                    old, new)
    got = ped.edit(wav, UtteranceAlignment(phones, bounds[:-1], bounds[1:],
                                           w2p), old, new)
    assert got.old_span_boundary == want.old_span_boundary
    assert got.new_span_boundary == want.new_span_boundary
    ref_mel = np.asarray(want.mel_edited)
    assert got.mel_edited.shape == ref_mel.shape
    mel_err = np.abs(got.mel_edited - ref_mel).max() / np.abs(ref_mel).max()
    ref_wav = np.asarray(want.prediction)
    assert got.prediction.shape == ref_wav.shape
    wav_err = np.abs(got.prediction - ref_wav).max() / np.abs(ref_wav).max()
    print(f"trained edit: mel {mel_err:.3g}, wav {wav_err:.3g} of the "
          "largest value")
    assert mel_err < MEL_TOL and wav_err < WAV_TOL
    assert np.abs(ref_wav).max() > 0.01


@pytest.mark.parametrize("grow", [False, True])
def test_warm_start_matches_jax(stash, grow):
    """JAX's warm_start_params onto its fp32 init and the port's onto the
    same init: every parameter equal; with grow_vocab the template's table
    has 7 more rows, which keep their init."""
    from a3t_tpu.models import A3TMLMModel
    from a3t_tpu.train.checkpoint import warm_start_params as jax_warm
    from a3t_tpu_torch.train.checkpoint import warm_start_params

    _, model_cfg, init = stash
    if grow:
        model_cfg = dataclasses.replace(
            model_cfg, vocab_size=model_cfg.vocab_size + 7)
        init = _np_tree(jax.jit(A3TMLMModel(model_cfg).init)(
            jax.random.PRNGKey(1), **_dummy()))
    want = _np_tree(jax_warm(init["params"], STASH, grow_vocab=grow))
    model = _port_model(model_cfg, init)
    warm_start_params(model, STASH, grow_vocab=grow)
    ref = mlm_state({"params": want, "batch_stats": init["batch_stats"]})
    got = model.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if grow:
        with pytest.raises(ValueError, match="shape mismatch"):
            warm_start_params(model, STASH)


def _write_jax_experiment(exp_dir, variables: list, config_writer):
    """checkpoints/epoch_1, epoch_2 (step, params, batch_stats) and
    ave_2best (params) written by orbax, LATEST = 2."""
    import orbax.checkpoint as ocp

    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    os.makedirs(ckpt_dir)
    config_writer(os.path.join(exp_dir, "config.yaml"))
    saver = ocp.StandardCheckpointer()
    for e, v in ((1, variables[0]), (2, variables[1])):
        saver.save(os.path.join(ckpt_dir, f"epoch_{e}"),
                   {"step": np.int32(e), "params": v["params"],
                    "batch_stats": v["batch_stats"]})
    saver.save(os.path.join(ckpt_dir, "ave_2best"),
               {"params": variables[2]["params"]})
    saver.wait_until_finished()
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write("2")


def _with_stats(v, seed):
    rng = np.random.default_rng(seed)
    v = _np_tree(v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.1, 0.6, s.shape)).astype(np.float32),
        v["batch_stats"])
    return v


TOKENS = ["<blank>", "<unk>", "AA", "B", "K", "IY", "S", "<sos/eos>"]
TINY = [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
        for k, v in (("attention_dim", 16), ("linear_units", 16),
                     ("num_blocks", 1))]


def _assert_states(model, ref):
    got = model.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_jax_mlm_experiment(tmp_path):
    from a3t_tpu.tasks.config import load_config as jax_load_config
    from a3t_tpu.tasks.mlm import MLMTask as JaxMLMTask
    from a3t_tpu_torch.tasks.config import load_config, save_config
    from a3t_tpu_torch.tasks.mlm import MLMTask

    exp = str(tmp_path / "mlm")
    cfg = load_config(os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml"),
                      TINY + ["frontend.n_mels=20", "model.postnet_layers=1",
                              "model.postnet_chans=8"])
    os.makedirs(exp)
    with open(os.path.join(exp, "tokens.txt"), "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    save_config(cfg, os.path.join(exp, "config.yaml"))
    jcfg = jax_load_config(os.path.join(exp, "config.yaml"))
    jm = JaxMLMTask.build_model(jcfg, len(TOKENS))
    init = jax.jit(jm.init)
    variables = [_with_stats(init(jax.random.PRNGKey(k), **_dummy(odim=20)),
                             k) for k in range(3)]
    _write_jax_experiment(exp, variables, lambda p: None)
    for which in ("ave", "latest", "epoch_1"):
        _, want, _, _ = JaxMLMTask.build_model_from_dir(exp, which)
        model, got_cfg, conv = MLMTask.build_model_from_dir(exp, which,
                                                            device="cpu")
        assert got_cfg == cfg and len(conv) == len(TOKENS)
        _assert_states(model, mlm_state(_np_tree(want)))
    # the choices differ: ave's params, epoch 2's statistics
    ave = mlm_state({"params": variables[2]["params"],
                     "batch_stats": variables[1]["batch_stats"]})
    model, _, _ = MLMTask.build_model_from_dir(exp, "ave", device="cpu")
    _assert_states(model, ave)


def test_jax_fs2_experiment(tmp_path):
    from a3t_tpu.tasks import config as jax_task_config
    from a3t_tpu.tasks import fs2 as jax_fs2_task
    from a3t_tpu_torch.tasks.config import save_config
    from a3t_tpu_torch.tasks.fs2 import FS2Task, load_fs2_config

    exp = str(tmp_path / "fs2")
    sets = TINY + ["frontend.n_mels=20", "model.adim=16",
                   "model.postnet_layers=1", "model.postnet_chans=8",
                   "model.gst_heads=2", "model.gst_conv_chans_list=[4,4,8]",
                   "model.gst_gru_units=8", "model.spk_embed_dim=4",
                   "model.max_feat_len=64"]
    sets += [f"model.{n}_predictor_chans=8"
             for n in ("duration", "pitch", "energy")]
    cfg = load_fs2_config(os.path.join(ROOT, "configs",
                                       "fs2_conformer_24k.yaml"), sets)
    os.makedirs(exp)
    with open(os.path.join(exp, "tokens.txt"), "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    save_config(cfg, os.path.join(exp, "config.yaml"))
    jcfg = jax_task_config._build(
        jax_fs2_task.FS2TaskConfig,
        jax_task_config.load_yaml_dict(os.path.join(exp, "config.yaml")))
    jm = jax_fs2_task.FS2Task.build_model(jcfg, len(TOKENS))
    rng = np.random.default_rng(0)
    b, t, frames = 1, 6, 32
    inputs = dict(
        text=jnp.asarray(rng.integers(1, len(TOKENS), (b, t)), jnp.int32),
        text_mask=jnp.ones((b, t), bool),
        speech=jnp.asarray(rng.standard_normal((b, frames, 20)), jnp.float32),
        spembs=jnp.asarray(rng.standard_normal((b, 4)), jnp.float32),
        durations=jnp.full((b, t), 2, jnp.int32),
        pitch=jnp.zeros((b, t, 1)), energy=jnp.zeros((b, t, 1)))
    init = jax.jit(jm.init)
    variables = [_with_stats(init(jax.random.PRNGKey(k), **inputs), k)
                 for k in range(3)]
    _write_jax_experiment(exp, variables, lambda p: None)
    for which in ("ave", "latest", "epoch_1"):
        _, want, _, _ = jax_fs2_task.FS2Task.build_model_from_dir(exp, which)
        model, _, conv = FS2Task.build_model_from_dir(exp, which,
                                                      device="cpu")
        assert len(conv) == len(TOKENS)
        _assert_states(model, fs2_state(_np_tree(want)))


def test_trained_vocoder_equals_converted_copy():
    from a3t_tpu_torch.train.vocoder import TRAINED_16K, load_vocoder

    tree = restore_portable(os.path.join(VOCODER, "state"),
                            only=("params_g",))
    from a3t_tpu_torch.compat.from_jax import pwg_state

    got = pwg_state({"params": tree["params_g"]})
    want = torch.load(os.path.join(TRAINED_16K, "state.pt"),
                      weights_only=True)["params_g"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.from_numpy(got[k]), v), k
    check = np.load(os.path.join(TRAINED_16K, "check.npz"))
    a = load_vocoder(VOCODER, device="cpu")(check["mel"], z=check["z"])
    b = load_vocoder(TRAINED_16K, device="cpu")(check["mel"], z=check["z"])
    assert torch.equal(a, b)
