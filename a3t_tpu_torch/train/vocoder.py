"""Neural vocoder training: the ParallelWaveGAN generator with the
multi-resolution STFT loss and an LSGAN discriminator
(``a3t_tpu/train/vocoder.py:48-428``).

The reference downloads published ``parallel_wavegan`` checkpoints
(sedit_inference.py:339-348); a corpus without one trains its own here.

* The host assembles fixed-shape crop batches from an in-memory corpus
  (:class:`VocoderData`): mel frames [f0, f0 + F) pair with samples
  [f0 * hop, (f0 + F) * hop) of the same utterance, and the mel is
  normalised by the corpus statistics, which the checkpoint keeps, so that
  inference takes the acoustic model's raw log10-mel.
* Until ``disc_start_step`` a step trains the generator on the spectral
  losses alone (:func:`spectral_step`); from then on the generator also
  takes the LSGAN loss against the discriminator, which then trains on the
  real waveform and the step's generated one, computed before the
  generator's update and detached (:func:`adversarial_step`).
* Each network has its own ``clip_by_global_norm -> adam`` at a constant
  rate (:class:`~a3t_tpu_torch.train.optim.ClipAdam`).
* The noise of step ``n`` comes from a ``torch.Generator`` on the device
  seeded from ``(seed, n)`` (JAX draws it from ``fold_in(PRNGKey(seed),
  n)``, which PyTorch cannot reproduce).

The checkpoint is ``out_dir/state.pt`` (step, both networks' weights and
both optimizers' states) beside JAX's ``vocoder.json`` (front-end, generator
config, mel statistics) and ``history.json``; the JAX package keeps the
state in orbax's ``state/`` instead, which the port does not read.  As in
JAX, a resumed run restarts its crop generator from ``seed``, so its
batches differ from an uninterrupted run's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.frontend import (LogMelConfig, LogMelFrontend,
                                        corpus_mvn, extract_corpus_mels)
from a3t_tpu_torch.dsp.stft import stft as _stft
from a3t_tpu_torch.models.pwg import (ParallelWaveGANGenerator, PWGConfig,
                                      PWGDiscriminator, init_parameters)
from a3t_tpu_torch.train.optim import AdamState, ClipAdam

# the JAX package's trained 16 kHz vocoder (artifacts/vocoder) in the
# port's form: state.pt, vocoder.json and check.npz (a mel, JAX's noise and
# JAX's wav for them)
TRAINED_16K = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "vocoder_16k")

# (n_fft, hop, win) of the upstream MultiResolutionSTFTLoss defaults
# (parallel_wavegan stft_loss.py), the published vocoders' objective
STFT_RESOLUTIONS: tuple = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def upsample_scales_for_hop(hop: int) -> tuple:
    """Factor ``hop`` into upsample scales, largest first."""
    scales, h = [], hop
    for p in (5, 5, 4, 4, 3, 3, 2, 2):
        if h % p == 0 and h != p:
            scales.append(p)
            h //= p
    if h != 1:
        scales.append(h)
    if int(np.prod(scales)) != hop:
        raise ValueError(f"cannot factor hop {hop} into upsample scales")
    return tuple(scales)


def spectral_losses(wav_hat: torch.Tensor, wav: torch.Tensor,
                    resolutions: Sequence[tuple] = STFT_RESOLUTIONS):
    """Multi-resolution STFT loss: (spectral convergence, log-magnitude
    L1), each averaged over the resolutions.  Spectral convergence is one
    Frobenius norm over the whole batch, not one per utterance."""
    sc_total = mag_total = 0.0
    for n_fft, hop, win in resolutions:
        m_hat = torch.abs(_stft(wav_hat, n_fft, hop, win))
        m_ref = torch.abs(_stft(wav, n_fft, hop, win))
        m_hat = torch.sqrt(torch.clamp(m_hat * m_hat, min=1e-7))
        m_ref = torch.sqrt(torch.clamp(m_ref * m_ref, min=1e-7))
        sc_total = sc_total + (torch.linalg.vector_norm(m_ref - m_hat)
                               / torch.linalg.vector_norm(m_ref))
        mag_total = mag_total + torch.mean(torch.abs(torch.log(m_ref)
                                                     - torch.log(m_hat)))
    n = float(len(resolutions))
    return sc_total / n, mag_total / n


@dataclasses.dataclass(frozen=True)
class VocoderTrainConfig:
    """JAX's ``VocoderTrainConfig`` field for field."""

    batch_size: int = 8
    crop_frames: int = 96
    total_steps: int = 50000
    # the discriminator joins once the spectral losses have shaped the
    # generator (upstream: discriminator_train_start_steps)
    disc_start_step: int = 20000
    lambda_adv: float = 4.0
    gen_lr: float = 1e-4
    disc_lr: float = 5e-5
    grad_clip: float = 10.0
    log_interval: int = 500
    save_interval: int = 5000
    seed: int = 0
    residual_channels: int = 64
    layers: int = 30
    stacks: int = 3
    # JAX's phase-decomposed dilated convolutions, a lowering with the same
    # parameters: written to vocoder.json, no effect on the port
    phase_conv: bool = False


class VocoderData:
    """In-memory (wav, mel) corpus with frame-aligned random crops.

    The mels come from :func:`extract_corpus_mels` on ``device`` (cuda
    unless the caller asks for the CPU).  With ``cache_path`` the cut
    waveforms, mels and statistics are kept in one ``.npz`` under JAX's
    layout and key (the front-end config, ``max_utts`` and the md5 of
    ``wav.scp``): a matching cache is read instead of the corpus, a stale
    one is rebuilt."""

    def __init__(self, wav_scp: str, fe_cfg: LogMelConfig,
                 max_utts: Optional[int] = None,
                 cache_path: Optional[str] = None, device=None):
        from a3t_tpu_torch.data.fileio import SoundScpReader

        self.hop = fe_cfg.hop_length
        with open(wav_scp, "rb") as f:
            scp_md5 = hashlib.md5(f.read()).hexdigest()
        cache_key = json.dumps({
            "fe": dataclasses.asdict(fe_cfg), "max_utts": max_utts,
            "scp_md5": scp_md5}, sort_keys=True)
        if cache_path and os.path.exists(cache_path):
            with np.load(cache_path) as z:
                stored = str(z["cache_key"]) if "cache_key" in z else None
                if stored == cache_key:
                    wav_cat, mel_cat = z["wav_cat"], z["mel_cat"]
                    wav_off, mel_off = z["wav_offsets"], z["mel_offsets"]
                    self.utts = [(wav_cat[wav_off[i]:wav_off[i + 1]],
                                  mel_cat[mel_off[i]:mel_off[i + 1]])
                                 for i in range(len(wav_off) - 1)]
                    self.mel_mean, self.mel_std = z["mel_mean"], z["mel_std"]
                    return
            print(f"vocoder: cache {cache_path} stale (key mismatch), "
                  "re-extracting", flush=True)
        reader = SoundScpReader(wav_scp)
        uids = list(reader.keys())
        if max_utts:
            uids = uids[:max_utts]
        wavs = []
        for uid in uids:
            fs, wav = reader[uid]
            if fs != fe_cfg.fs:
                raise ValueError(f"{uid}: fs {fs} != frontend fs {fe_cfg.fs}")
            wavs.append(wav)
        trunc, mels = extract_corpus_mels(LogMelFrontend(fe_cfg, device),
                                          wavs)
        self.utts = list(zip(trunc, mels))
        self.mel_mean, self.mel_std = corpus_mvn(mels)
        if cache_path:
            tmp = cache_path + ".tmp.npz"
            np.savez(
                tmp,
                wav_cat=np.concatenate([w for w, _ in self.utts]),
                mel_cat=np.concatenate([m for _, m in self.utts], axis=0),
                wav_offsets=np.cumsum([0] + [len(w) for w, _ in self.utts]),
                mel_offsets=np.cumsum([0] + [len(m) for _, m in self.utts]),
                mel_mean=self.mel_mean, mel_std=self.mel_std,
                cache_key=np.str_(cache_key))
            os.replace(tmp, cache_path)

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     crop_frames: int):
        """((B, crop_frames, n_mels) normalised mels, (B, crop_frames *
        hop) waveforms), ``rng``'s draws in JAX's order; an utterance not
        longer than the crop is tiled."""
        crop_s = crop_frames * self.hop
        mel = np.empty((batch_size, crop_frames, self.utts[0][1].shape[-1]),
                       np.float32)
        wav = np.empty((batch_size, crop_s), np.float32)
        for b in range(batch_size):
            wi, mi = self.utts[rng.integers(len(self.utts))]
            max_f0 = mi.shape[0] - crop_frames
            if max_f0 <= 0:
                reps = int(np.ceil(crop_frames / max(mi.shape[0], 1)))
                mi = np.tile(mi, (reps, 1))[:crop_frames]
                wi = np.tile(wi, reps)[:crop_s]
                f0 = 0
            else:
                f0 = int(rng.integers(max_f0 + 1))
            mel[b] = mi[f0: f0 + crop_frames]
            wav[b] = wi[f0 * self.hop: f0 * self.hop + crop_s]
        mel = (mel - self.mel_mean) / self.mel_std
        return mel, wav


def generator_config(fe_cfg: LogMelConfig,
                     cfg: VocoderTrainConfig) -> PWGConfig:
    """The generator a run of ``cfg`` trains for ``fe_cfg``."""
    return PWGConfig(upsample_scales=upsample_scales_for_hop(
        fe_cfg.hop_length), aux_channels=fe_cfg.n_mels,
        residual_channels=cfg.residual_channels,
        skip_channels=cfg.residual_channels,
        gate_channels=2 * cfg.residual_channels, layers=cfg.layers,
        stacks=cfg.stacks)


def step_noise(seed: int, step: int, shape, device) -> torch.Tensor:
    """Step ``step``'s standard-normal generator noise on ``device``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    g = torch.Generator(device=device).manual_seed(s)
    return torch.randn(shape, generator=g, device=device)


def spectral_step(gen, tx_g: ClipAdam, opt_g: AdamState, mel, wav, z):
    """One generator update on the spectral losses; (loss, sc, mag)."""
    params = list(gen.parameters())
    sc, mag = spectral_losses(gen(mel, z), wav)
    loss = sc + mag
    tx_g.apply(params, torch.autograd.grad(loss, params), opt_g)
    return loss.detach(), sc.detach(), mag.detach()


def adversarial_step(gen, disc, tx_g: ClipAdam, tx_d: ClipAdam,
                     opt_g: AdamState, opt_d: AdamState, mel, wav, z,
                     lambda_adv: float):
    """The generator's update on spectral + ``lambda_adv`` x LSGAN loss
    against the current discriminator, then the discriminator's on the real
    waveform (target 1) and the pre-update generator's, detached (target
    0); (g_loss, sc, mag, adv, d_loss).  The generator's loss takes
    gradients with respect to the generator's parameters only."""
    g_params, d_params = list(gen.parameters()), list(disc.parameters())
    wav_hat = gen(mel, z)
    sc, mag = spectral_losses(wav_hat, wav)
    adv = torch.mean((disc(wav_hat) - 1.0) ** 2)
    g_loss = sc + mag + lambda_adv * adv
    tx_g.apply(g_params, torch.autograd.grad(g_loss, g_params), opt_g)
    wav_hat = wav_hat.detach()
    d_loss = (torch.mean((disc(wav) - 1.0) ** 2)
              + torch.mean(disc(wav_hat) ** 2))
    tx_d.apply(d_params, torch.autograd.grad(d_loss, d_params), opt_d)
    return (g_loss.detach(), sc.detach(), mag.detach(), adv.detach(),
            d_loss.detach())


def save_checkpoint(out_dir: str, tree: dict, history: list) -> None:
    """Write ``state.pt`` (through a temporary file, so that a run cut
    while saving keeps the previous one) and then ``history.json``."""
    path = os.path.join(out_dir, "state.pt")
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(history, f)


def train_vocoder(wav_scp: str, out_dir: str, fe_cfg: LogMelConfig,
                  cfg: VocoderTrainConfig = VocoderTrainConfig(),
                  max_utts: Optional[int] = None,
                  corpus_cache: Optional[str] = None,
                  log_fn: Callable[[str], None] = print,
                  device=None) -> str:
    """Train a PWG vocoder on a ``wav.scp`` corpus on ``device`` (cuda
    unless the caller asks for the CPU); returns ``out_dir``.

    Resumable: a run finding ``out_dir/state.pt`` continues from its step
    with its weights, optimizer states and the mel statistics stored in
    ``vocoder.json``, and keeps the history up to that step."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    gcfg = generator_config(fe_cfg, cfg)
    gen = init_parameters(ParallelWaveGANGenerator(gcfg),
                          torch.Generator().manual_seed(cfg.seed)).to(dev)
    disc = init_parameters(PWGDiscriminator(),
                           torch.Generator().manual_seed(cfg.seed + 1)
                           ).to(dev)
    gen.train()
    disc.train()

    log_fn(f"vocoder: loading corpus {wav_scp} ...")
    data = VocoderData(wav_scp, fe_cfg, max_utts=max_utts,
                       cache_path=corpus_cache, device=dev)
    log_fn(f"vocoder: {len(data.utts)} utts in memory")

    tx_g = ClipAdam(cfg.gen_lr, cfg.grad_clip)
    tx_d = ClipAdam(cfg.disc_lr, cfg.grad_clip)
    opt_g, opt_d = tx_g.init(gen.parameters()), tx_d.init(disc.parameters())
    step = 0
    state_path = os.path.join(out_dir, "state.pt")
    meta_path = os.path.join(out_dir, "vocoder.json")
    hist_path = os.path.join(out_dir, "history.json")
    resumed = os.path.exists(state_path)
    if resumed:
        tree = torch.load(state_path, map_location=dev, weights_only=True)
        step = int(tree["step"])
        gen.load_state_dict(tree["params_g"])
        disc.load_state_dict(tree["params_d"])
        opt_g, opt_d = AdamState(**tree["opt_g"]), AdamState(**tree["opt_d"])
        log_fn(f"vocoder: resumed at step {step}")
        if os.path.exists(meta_path):
            # the statistics the restored weights were trained under
            with open(meta_path) as f:
                old_meta = json.load(f)
            data.mel_mean = np.asarray(old_meta["mel_mean"], np.float32)
            data.mel_std = np.asarray(old_meta["mel_std"], np.float32)
            log_fn("vocoder: reusing stored mel MVN from vocoder.json")
    with open(meta_path, "w") as f:
        json.dump({"frontend": dataclasses.asdict(fe_cfg),
                   "pwg": {**dataclasses.asdict(gcfg),
                           "phase_conv": cfg.phase_conv},
                   "mel_mean": data.mel_mean.tolist(),
                   "mel_std": data.mel_std.tolist()}, f)

    history = []
    if resumed and os.path.exists(hist_path):
        with open(hist_path) as f:
            history = [h for h in json.load(f) if h.get("step", 0) <= step]
    rng = np.random.default_rng(cfg.seed)
    crop_s = cfg.crop_frames * fe_cfg.hop_length
    t0 = time.time()
    while step < cfg.total_steps:
        mel, wav = data.sample_batch(rng, cfg.batch_size, cfg.crop_frames)
        mel = torch.as_tensor(mel, device=dev)
        wav = torch.as_tensor(wav, device=dev)
        z = step_noise(cfg.seed, step, (cfg.batch_size, crop_s), dev)
        if step < cfg.disc_start_step:
            loss, sc, mag = spectral_step(gen, tx_g, opt_g, mel, wav, z)
            stats = {"loss": loss, "sc": sc, "mag": mag}
        else:
            loss, sc, mag, adv, d_loss = adversarial_step(
                gen, disc, tx_g, tx_d, opt_g, opt_d, mel, wav, z,
                cfg.lambda_adv)
            stats = {"loss": loss, "sc": sc, "mag": mag, "adv": adv,
                     "d": d_loss}
        step += 1
        if step % cfg.log_interval == 0 or step == cfg.total_steps:
            s = {k: round(float(v), 4) for k, v in stats.items()}
            rate = cfg.log_interval / (time.time() - t0)
            t0 = time.time()
            history.append({"step": step, **s})
            log_fn(f"vocoder step {step}/{cfg.total_steps} {s} "
                   f"({rate:.1f} it/s)")
        if step % cfg.save_interval == 0 or step == cfg.total_steps:
            save_checkpoint(out_dir, {
                "step": step, "params_g": gen.state_dict(),
                "params_d": disc.state_dict(),
                "opt_g": dataclasses.asdict(opt_g),
                "opt_d": dataclasses.asdict(opt_d)}, history)
    return out_dir


def load_vocoder(out_dir: str, device=None):
    """A trained vocoder directory -> ``vocode(mel, z=None)`` on ``device``
    (cuda unless the caller asks for the CPU): the acoustic model's raw
    log10-mel (B, F, n_mels) or (F, n_mels), an array or a tensor, ->
    (B, F * hop) float32 tensor on the device.  The frames are edge-padded
    to a multiple of 64 and normalised by ``vocoder.json``'s statistics;
    the noise ``z`` (B, F_pad * hop) is drawn from a generator seeded with
    0 in every call unless given.  A directory without ``state.pt`` (the
    JAX package's orbax ``state/``) raises; the trained 16 kHz vocoder of
    ``artifacts/vocoder`` is in the port's form in ``TRAINED_16K``."""
    dev = resolve_device(device)
    state_path = os.path.join(out_dir, "state.pt")
    if not os.path.exists(state_path):
        raise NotImplementedError(
            f"{out_dir} holds no state.pt: a vocoder directory of the JAX "
            "package (orbax) cannot be read by the port (ROADMAP A2); the "
            f"trained 16 kHz vocoder is converted in {TRAINED_16K}")
    with open(os.path.join(out_dir, "vocoder.json")) as f:
        meta = json.load(f)
    names = {f.name for f in dataclasses.fields(PWGConfig)}
    gcfg = PWGConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in meta["pwg"].items() if k in names})
    hop = gcfg.upsample_factor
    gen = ParallelWaveGANGenerator(gcfg)
    gen.load_state_dict(torch.load(state_path, map_location="cpu",
                                   weights_only=True)["params_g"])
    gen = gen.to(dev).eval()
    mean = torch.as_tensor(np.asarray(meta["mel_mean"], np.float32),
                           device=dev)
    std = torch.as_tensor(np.asarray(meta["mel_std"], np.float32),
                          device=dev)
    noise = torch.Generator(device=dev)

    def vocode(mel, z=None) -> torch.Tensor:
        mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
        if mel.dim() == 2:
            mel = mel[None]
        n_frames = mel.shape[1]
        pad_f = -(-n_frames // 64) * 64
        mel_p = F.pad(mel.transpose(1, 2), (0, pad_f - n_frames),
                      mode="replicate").transpose(1, 2)
        with torch.inference_mode():
            wav = gen((mel_p - mean) / std,
                      None if z is None else torch.as_tensor(z, device=dev),
                      generator=noise.manual_seed(0))
        return wav[:, : n_frames * hop]

    return vocode
