"""The port's vocoder trainer (a3t_tpu_torch/train/vocoder.py,
models/pwg.py's discriminator, compat/from_jax.py's scan-layout carry,
dsp/frontend.py's corpus helpers, bin/train_vocoder.py and
bin.mcd_gate --vocoder DIR) against the JAX package, on the CPU, at a
narrow width (4 residual blocks in 2 stacks of 8 channels).

Tolerances (fp32):

* upsample scales exactly; the corpus mels within 1e-4 (the two FFTs round
  differently; log10-mels of O(1)); the waveform crops and the crops read
  from JAX's corpus cache bit for bit;
* the STFT magnitudes, spectral losses, discriminator and generator
  outputs within 1e-5 of their largest value;
* one spectral and one adversarial step from carried weights with explicit
  noise: each loss within rtol 1e-5 and each parameter of both networks
  within 1e-6 (lr 1e-4 and 5e-5).  Adam's eps is 1e-3 on both sides there,
  for tests/test_torch_train.py's reason: a first Adam step is ~sign(g)
  for any |g| above eps, so a parameter whose gradient is rounding noise
  would move by +-lr at random; ClipAdam itself is held to optax at eps
  1e-8 on gradients far above it;
* load_vocoder against JAX's vocode with JAX's own noise: within 1e-4 of
  the largest sample.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.dsp import frontend as jax_frontend
from a3t_tpu.dsp.stft import stft as jax_stft
from a3t_tpu.models import pwg as jax_pwg
from a3t_tpu.train import vocoder as jax_vocoder
from a3t_tpu_torch.bin import mcd_gate
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.bin.train_vocoder import main as train_vocoder_main
from a3t_tpu_torch.compat.from_jax import (load_state,
                                           pwg_discriminator_state,
                                           pwg_state)
from a3t_tpu_torch.data.fileio import SoundScpReader, read_2column_text
from a3t_tpu_torch.data.miniature import generate_speechlike_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.dsp.frontend import corpus_mvn, extract_corpus_mels
from a3t_tpu_torch.dsp.stft import stft
from a3t_tpu_torch.models.pwg import (ParallelWaveGANGenerator, PWGConfig,
                                      PWGDiscriminator)
from a3t_tpu_torch.train import vocoder
from a3t_tpu_torch.train.optim import ClipAdam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")
FE = dict(fs=16000, n_fft=1024, hop_length=200, win_length=800, n_mels=20)
TINY = dict(batch_size=2, crop_frames=8, residual_channels=8, layers=4,
            stacks=2)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc")
    return (generate_speechlike_corpus(str(d / "c16"), n_utts=6,
                                       n_speakers=2, fs=16000, seed=4,
                                       n_phones_range=(4, 10)),
            generate_speechlike_corpus(str(d / "c24"), n_utts=3,
                                       n_speakers=2, fs=24000, seed=5,
                                       n_phones_range=(6, 9)))


@pytest.mark.parametrize("hop", [300, 256, 200, 240, 120, 50, 21, 7, 2])
def test_upsample_scales_equal_jax(hop):
    assert vocoder.upsample_scales_for_hop(hop) == \
        jax_vocoder.upsample_scales_for_hop(hop)


def test_stft_and_spectral_losses_match_jax():
    """The port's STFT against JAX's at the three resolutions, and the
    losses (one Frobenius norm over the batch)."""
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((2, 4800)).astype(np.float32) * 0.3
    wav_hat = wav + rng.standard_normal((2, 4800)).astype(np.float32) * 0.1
    for n_fft, hop, win in vocoder.STFT_RESOLUTIONS:
        _close(torch.abs(stft(torch.tensor(wav), n_fft, hop, win)).numpy(),
               jax.jit(lambda x: jnp.abs(jax_stft(x, n_fft, hop, win)))(wav),
               1e-5)
    got = vocoder.spectral_losses(torch.tensor(wav_hat), torch.tensor(wav))
    want = jax.jit(jax_vocoder.spectral_losses)(wav_hat, wav)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-5)


def _jax_nets(hop):
    gcfg = vocoder.generator_config(LogMelConfig(**{**FE, "hop_length": hop}),
                                    vocoder.VocoderTrainConfig(**TINY))
    jcfg = jax_pwg.PWGConfig(**dataclasses.asdict(gcfg))
    return (gcfg, jax_pwg.ParallelWaveGANGeneratorScan(jcfg),
            jax_pwg.PWGDiscriminator())


def test_discriminator_and_scan_generator_match_jax():
    """The JAX discriminator and the trainer's scan-layout generator,
    carried into the port, give the same outputs (explicit noise)."""
    gcfg, gen, disc = _jax_nets(200)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 8, 20)).astype(np.float32)
    z = rng.standard_normal((2, 1600, 1)).astype(np.float32)
    pg = jax.jit(gen.init)(jax.random.PRNGKey(0), mel, z)
    assert "stacks" in pg["params"]
    pd = jax.jit(disc.init)(jax.random.PRNGKey(1), z[..., 0])
    port_g = load_state(ParallelWaveGANGenerator(gcfg), pwg_state(pg))
    port_d = load_state(PWGDiscriminator(), pwg_discriminator_state(pd))
    with torch.no_grad():
        wav = port_g(torch.tensor(mel), torch.tensor(z))
        logits = port_d(torch.tensor(z[..., 0]))
    _close(wav.numpy(), jax.jit(gen.apply)(pg, mel, z), 1e-5)
    _close(logits.numpy(), jax.jit(disc.apply)(pd, z[..., 0]), 1e-5)


def test_clip_adam_matches_optax():
    rng = np.random.default_rng(2)
    params = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (5,))]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    jp, js = [jnp.asarray(p) for p in params], None
    js = tx.init(jp)
    port = [torch.tensor(p) for p in params]
    ctx = ClipAdam(1e-2, 1.0)
    state = ctx.init(port)
    for i in range(3):
        grads = [rng.standard_normal(p.shape).astype(np.float32) * (i + 1)
                 for p in params]
        u, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, u)
        ctx.apply(port, [torch.tensor(g) for g in grads], state)
    for a, b in zip(port, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=0)
    assert int(state.count) == 3


def test_spectral_and_adversarial_steps_match_jax():
    """One step of each kind from the same weights and noise, JAX's step
    functions (vocoder.py:279-326) against the port's, leaf by leaf."""
    gcfg, gen, disc = _jax_nets(200)
    cfg = vocoder.VocoderTrainConfig(**TINY)
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 8, 20)).astype(np.float32)
    wav = rng.standard_normal((2, 1600)).astype(np.float32) * 0.3
    z = rng.standard_normal((2, 1600, 1)).astype(np.float32)
    pg = jax.jit(gen.init)(jax.random.PRNGKey(0), mel, z)["params"]
    pd = jax.jit(disc.init)(jax.random.PRNGKey(1), wav)["params"]
    tx_g = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                       optax.adam(cfg.gen_lr, eps=1e-3))
    tx_d = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                       optax.adam(cfg.disc_lr, eps=1e-3))

    @jax.jit
    def jax_spectral(pg, og):
        def loss_fn(p):
            sc, mag = jax_vocoder.spectral_losses(
                gen.apply({"params": p}, mel, z), wav)
            return sc + mag, (sc, mag)

        (loss, (sc, mag)), g = jax.value_and_grad(loss_fn, has_aux=True)(pg)
        u, og = tx_g.update(g, og, pg)
        return optax.apply_updates(pg, u), og, loss, sc, mag

    @jax.jit
    def jax_adversarial(pg, pd, og, od):
        def g_loss_fn(p):
            wav_hat = gen.apply({"params": p}, mel, z)
            sc, mag = jax_vocoder.spectral_losses(wav_hat, wav)
            adv = jnp.mean((disc.apply({"params": pd}, wav_hat) - 1.0) ** 2)
            return sc + mag + cfg.lambda_adv * adv, (sc, mag, adv, wav_hat)

        (gl, (sc, mag, adv, wav_hat)), g = jax.value_and_grad(
            g_loss_fn, has_aux=True)(pg)
        u, og = tx_g.update(g, og, pg)
        pg = optax.apply_updates(pg, u)

        def d_loss_fn(p):
            return (jnp.mean((disc.apply({"params": p}, wav) - 1.0) ** 2)
                    + jnp.mean(disc.apply({"params": p},
                                          jax.lax.stop_gradient(wav_hat))
                               ** 2))

        dl, g = jax.value_and_grad(d_loss_fn)(pd)
        u, od = tx_d.update(g, od, pd)
        return pg, optax.apply_updates(pd, u), og, od, gl, sc, mag, adv, dl

    port_g = load_state(ParallelWaveGANGenerator(gcfg),
                        pwg_state({"params": pg}))
    port_d = load_state(PWGDiscriminator(),
                        pwg_discriminator_state({"params": pd}))
    ptx_g = ClipAdam(cfg.gen_lr, cfg.grad_clip, eps=1e-3)
    ptx_d = ClipAdam(cfg.disc_lr, cfg.grad_clip, eps=1e-3)
    opt_g, opt_d = ptx_g.init(port_g.parameters()), \
        ptx_d.init(port_d.parameters())
    t = [torch.tensor(a) for a in (mel, wav, z)]

    og, od = tx_g.init(pg), tx_d.init(pd)
    pg1, og, *want = jax_spectral(pg, og)
    got = vocoder.spectral_step(port_g, ptx_g, opt_g, *t)
    pg2, pd2, og, od, *want2 = jax_adversarial(pg1, pd, og, od)
    got2 = vocoder.adversarial_step(port_g, port_d, ptx_g, ptx_d, opt_g,
                                    opt_d, *t, cfg.lambda_adv)
    for g, w in zip(list(got) + list(got2), want + want2):
        assert float(g) == pytest.approx(float(w), rel=1e-5)
    for net, state in ((port_g, pwg_state({"params": pg2})),
                       (port_d, pwg_discriminator_state({"params": pd2}))):
        own = net.state_dict()
        for k, v in state.items():
            np.testing.assert_allclose(own[k].numpy(), v, atol=1e-6, rtol=0,
                                       err_msg=k)


def test_corpus_mels_and_mvn_match_jax(corpus):
    reader = SoundScpReader(os.path.join(corpus[0], "wav.scp"))
    wavs = [reader[u][1] for u in reader.keys()]
    trunc, mels = extract_corpus_mels(
        LogMelFrontend(LogMelConfig(**FE), device="cpu"), wavs, chunk=4)
    jtrunc, jmels = jax_frontend.extract_corpus_mels(
        JaxLogMelFrontend(JaxLogMelConfig(**FE)), wavs, chunk=4)
    assert len(mels) == len(jmels) == 6
    for a, b, ja, jb in zip(trunc, mels, jtrunc, jmels):
        np.testing.assert_array_equal(a, ja)
        assert b.shape == jb.shape == (len(a) // 200, 20)
        np.testing.assert_allclose(b, jb, atol=1e-4, rtol=0)
    for g, w in zip(corpus_mvn(mels), jax_frontend.corpus_mvn(jmels)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_vocoder_data_crops_equal_jax(corpus, tmp_path):
    """Read from JAX's corpus cache, the port's crops equal JAX's bit for
    bit; extracted anew, the waveform crops still do and the mels agree;
    a cache of another front-end is stale and rebuilt."""
    scp = os.path.join(corpus[0], "wav.scp")
    cache = str(tmp_path / "cache.npz")
    jdata = jax_vocoder.VocoderData(scp, JaxLogMelConfig(**FE),
                                    cache_path=cache)
    cached = vocoder.VocoderData(scp, LogMelConfig(**FE), cache_path=cache,
                                 device="cpu")
    fresh = vocoder.VocoderData(scp, LogMelConfig(**FE), device="cpu")
    for crop in (8, 200):  # 200 frames: the short utterances are tiled
        want = jdata.sample_batch(np.random.default_rng(7), 5, crop)
        got = cached.sample_batch(np.random.default_rng(7), 5, crop)
        new = fresh.sample_batch(np.random.default_rng(7), 5, crop)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(new[1], want[1])
        np.testing.assert_allclose(new[0], want[0], atol=1e-3, rtol=0)
    other = vocoder.VocoderData(scp, LogMelConfig(**{**FE, "n_mels": 16}),
                                cache_path=cache, device="cpu")
    assert other.utts[0][1].shape[1] == 16
    with np.load(cache) as z:
        assert z["mel_cat"].shape[1] == 16


class _Stop(Exception):
    pass


def test_train_vocoder_resumes(corpus, tmp_path, monkeypatch):
    """A run stopped after its save at step 2 resumes there: the stored
    mel statistics are kept, the history is cut at the step, and the run
    ends at the last step with finite spectral and adversarial losses."""
    scp = os.path.join(corpus[0], "wav.scp")
    out = str(tmp_path / "voc")
    cfg = vocoder.VocoderTrainConfig(**TINY, total_steps=4,
                                     disc_start_step=2, log_interval=1,
                                     save_interval=2)
    save = vocoder.save_checkpoint

    def save_then_stop(out_dir, tree, history):
        save(out_dir, tree, history)
        if tree["step"] == 2:
            raise _Stop

    monkeypatch.setattr(vocoder, "save_checkpoint", save_then_stop)
    with pytest.raises(_Stop):
        vocoder.train_vocoder(scp, out, LogMelConfig(**FE), cfg,
                              log_fn=lambda s: None, device="cpu")
    monkeypatch.setattr(vocoder, "save_checkpoint", save)
    with open(os.path.join(out, "history.json")) as f:
        assert [h["step"] for h in json.load(f)] == [1, 2]
    with open(os.path.join(out, "history.json"), "w") as f:
        json.dump([{"step": s, "loss": 0.0} for s in (1, 2, 3, 9)], f)
    meta_path = os.path.join(out, "vocoder.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["mel_mean"] = [0.25] * 20
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    logs = []
    vocoder.train_vocoder(scp, out, LogMelConfig(**FE), cfg,
                          log_fn=logs.append, device="cpu")
    assert "vocoder: resumed at step 2" in logs
    with open(meta_path) as f:
        assert json.load(f)["mel_mean"] == [0.25] * 20
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(hist[-1][k]) for k in ("sc", "mag", "adv", "d"))
    tree = torch.load(os.path.join(out, "state.pt"), weights_only=True)
    assert tree["step"] == 4 and int(tree["opt_d"]["count"]) == 2


def test_load_vocoder_matches_jax_vocode(corpus, tmp_path):
    """JAX trains a vocoder for one step and saves it (orbax); its tree,
    carried by pwg_state into the port's state.pt beside the same
    vocoder.json, vocodes a mel as JAX's vocode does, with JAX's noise; so
    does JAX's directory itself, read by the port's orbax reader."""
    scp = os.path.join(corpus[0], "wav.scp")
    jdir = str(tmp_path / "jax")
    jax_vocoder.train_vocoder(
        scp, jdir, JaxLogMelConfig(**FE), jax_vocoder.VocoderTrainConfig(
            **TINY, total_steps=1, disc_start_step=5), log_fn=lambda s: None)
    from_jax_dir = vocoder.load_vocoder(jdir, device="cpu")
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(os.path.join(jdir, "state"))
    pdir = tmp_path / "port"
    pdir.mkdir()
    shutil.copy(os.path.join(jdir, "vocoder.json"), pdir / "vocoder.json")
    torch.save({"params_g": {k: torch.tensor(v) for k, v in pwg_state(
        {"params": tree["params_g"]}).items()}}, pdir / "state.pt")
    mel = np.random.default_rng(5).standard_normal((1, 70, 20)).astype(
        np.float32) - 4.0
    want = jax_vocoder.load_vocoder(jdir)(mel)
    z = jax.random.normal(jax.random.PRNGKey(0), (1, 128 * 200, 1))
    vocode = vocoder.load_vocoder(str(pdir), device="cpu")
    got = vocode(mel, z=np.array(z)[..., 0])
    assert got.shape == want.shape == (1, 70 * 200)
    _close(got.numpy(), want, 1e-4)
    assert torch.equal(from_jax_dir(mel, z=np.array(z)[..., 0]), got)
    a, b = vocode(mel[0]), vocode(torch.tensor(mel))
    assert torch.equal(a, b) and a.shape == (1, 70 * 200)


def test_train_vocoder_cli_and_mcd_gate(corpus, tmp_path):
    """bin.train_vocoder --device cpu at its 24 kHz defaults but for the
    crop, batch and steps, then bin.mcd_gate --vocoder DIR on an A3T
    experiment of the same front-end."""
    train, n_mels = corpus[1], 20
    vdir = str(tmp_path / "voc")
    train_vocoder_main([
        "--wav-scp", os.path.join(train, "wav.scp"), "--out", vdir,
        "--n-mels", str(n_mels), "--steps", "2", "--disc-start", "1",
        "--batch-size", "2", "--crop-frames", "8", "--save-interval", "1",
        "--device", "cpu"])
    assert sorted(os.listdir(vdir)) == ["history.json", "state.pt",
                                        "vocoder.json"]
    with open(os.path.join(vdir, "vocoder.json")) as f:
        meta = json.load(f)
    assert meta["pwg"]["upsample_scales"] == [5, 5, 4, 3]
    assert meta["pwg"]["layers"] == 30 and meta["pwg"]["phase_conv"] is False
    exp = str(tmp_path / "exp")
    sets = [f"train_data_dir={train}", f"valid_data_dir={train}",
            f"exp_dir={exp}", "model.postnet_layers=1",
            "model.postnet_chans=8", f"frontend.n_mels={n_mels}",
            "batcher.batch_bins=10240", "trainer.max_epoch=1",
            "trainer.num_iters_per_epoch=1"]
    sets += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
             for k, v in dict(attention_dim=16, linear_units=16,
                              num_blocks=1).items()]
    argv = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in sets:
        argv += ["--set", s]
    train_main(argv)
    uids = sorted(read_2column_text(os.path.join(train, "text")))[:1]
    out = str(tmp_path / "mcd")
    report = mcd_gate.main(["--exp-dir", exp, "--data-dir", train, "--uids",
                            ",".join(uids), "--vocoder", vdir, "--out", out,
                            "--device", "cpu"])
    assert report["n"] == 1 and os.path.exists(os.path.join(out, "MCD.json"))
    for prefix in ("sedit", "gt", "vocoder"):
        assert sorted(os.listdir(os.path.join(out, prefix, "full"))) == \
            [u + ".wav" for u in uids]
