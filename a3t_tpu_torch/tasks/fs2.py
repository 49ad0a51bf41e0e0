"""FastSpeech2 training task: the port of ``a3t_tpu/tasks/fs2.py`` (the
reference's TTSTask for the fastspeech2 choice, espnet2/tasks/tts.py), the
model whose duration predictor drives speech editing.

Per utterance (static shapes, bucketed by text length): phones and
alignments give durations (frames per phone); the waveform gives the mel
target (on the device, the step's matmul-DFT front-end) and, on the host,
F0 and energy targets (``dsp/pitch.py``) averaged over each phone's
frames.  :class:`FS2Batcher`'s batches equal the JAX package's bit for bit;
the Trainer's producer thread assembles them, as it does the A3T batcher's.

There is no CLI, as in JAX: the recipes call :meth:`FS2Task.run` on a
config read by :func:`load_fs2_config`.  Everything runs on cuda unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from a3t_tpu_torch.compat.from_jax import fs2_state
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.iterator import DeviceTransfer, EpochIterFactory
from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.dsp.pitch import (average_by_duration, extract_energy,
                                     extract_f0)
from a3t_tpu_torch.models.fastspeech2 import (FastSpeech2, FastSpeech2Config,
                                              build_fs2, fastspeech2_loss)
from a3t_tpu_torch.models.xvector import load_spk2xvector
from a3t_tpu_torch.parallel.mesh import world
from a3t_tpu_torch.tasks import yaml_subset
from a3t_tpu_torch.tasks.config import _build, apply_overrides, save_config
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train.checkpoint import (CheckpointManager,
                                            experiment_state)
from a3t_tpu_torch.train.optim import OptimConfig, make_optimizer
from a3t_tpu_torch.train.train_step import (TrainState, _check_device,
                                            _generator, create_train_state)
from a3t_tpu_torch.train.trainer import Trainer, TrainerConfig

logger = logging.getLogger("a3t_tpu_torch")


@dataclasses.dataclass
class FS2BatcherConfig:
    batch_size: int = 16
    text_buckets: Sequence[int] = (32, 64, 128)
    max_feat_len: int = 1024
    seed: int = 0


class FS2Batcher:
    """Static-shape FastSpeech2 batches: text (B, T) with eos, text_mask,
    durations (the eos takes the remaining frames), token-averaged pitch
    and energy (B, T, 1), audio (B, (max_feat_len - 1) * hop) with its
    lengths and, with ``spk2xvector``, the speakers' x-vectors ``spembs``
    (the corpus mean for a speaker missing from the table)."""

    def __init__(self, dataset: A3TDataset, frontend: LogMelConfig,
                 config: FS2BatcherConfig = FS2BatcherConfig(),
                 spk2xvector: Optional[dict] = None):
        self.dataset = dataset
        self.fe = frontend
        self.config = config
        self.spk2xvector = spk2xvector
        self._buckets: list[list[str]] = [[] for _ in config.text_buckets]
        bounds = sorted(config.text_buckets)
        for uid in dataset.uids:
            n = dataset.num_phones(uid)
            for bi, b in enumerate(bounds):
                if n <= b - 1:  # room for eos
                    self._buckets[bi].append(uid)
                    break

    def epoch_iterator(self, epoch: int, eos_id: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.config.seed, epoch]))
        cfg = self.config
        plan = []
        for bi, members in enumerate(self._buckets):
            order = list(members)
            rng.shuffle(order)
            for i in range(0, len(order), cfg.batch_size):
                plan.append((bi, order[i: i + cfg.batch_size]))
        rng.shuffle(plan)
        for bi, uids in plan:
            yield self.make_batch(bi, uids, eos_id)

    def make_batch(self, bucket_idx: int, uids: Sequence[str], eos_id: int):
        cfg = self.config
        t_pad = sorted(cfg.text_buckets)[bucket_idx]
        b = cfg.batch_size
        c = self.fe
        hop = c.hop_length

        text = np.zeros((b, t_pad), np.int32)
        text_mask = np.zeros((b, t_pad), bool)
        durations = np.zeros((b, t_pad), np.int32)
        pitch = np.zeros((b, t_pad, 1), np.float32)
        energy = np.zeros((b, t_pad, 1), np.float32)
        audio = np.zeros((b, (cfg.max_feat_len - 1) * hop), np.float32)
        audio_lengths = np.zeros(b, np.int32)
        spembs = mean_xv = None
        if self.spk2xvector is not None:
            edim = len(next(iter(self.spk2xvector.values())))
            spembs = np.zeros((b, edim), np.float32)
            mean_xv = np.mean(np.stack(list(self.spk2xvector.values())),
                              axis=0)

        for i, uid in enumerate(uids):
            item = self.dataset[uid]
            if spembs is not None:
                xv = self.spk2xvector.get(item.get("speaker", uid))
                spembs[i] = xv if xv is not None else mean_xv
            wav = item["audio"][: audio.shape[1]]
            ids = item["text_ids"]
            starts = np.floor(c.fs * item["align_start_sec"] / hop).astype(int)
            ends = np.floor(c.fs * item["align_end_sec"] / hop).astype(int)
            n_f = min(1 + len(wav) // hop, cfg.max_feat_len)
            ends = np.minimum(ends, n_f)
            starts = np.minimum(starts, ends)
            d = ends - starts
            t_len = min(len(ids), t_pad - 1)

            text[i, :t_len] = ids[:t_len]
            text[i, t_len] = eos_id
            text_mask[i, : t_len + 1] = True
            durations[i, :t_len] = d[:t_len]
            durations[i, t_len] = max(0, n_f - int(d[:t_len].sum()))

            f0 = extract_f0(wav, c.fs, hop)
            en = extract_energy(wav, c.n_fft, hop, c.win_length)
            pitch[i, :t_len, 0] = average_by_duration(f0, d[:t_len], True)
            energy[i, :t_len, 0] = average_by_duration(en, d[:t_len], False)

            audio[i, : len(wav)] = wav
            audio_lengths[i] = len(wav)

        out = dict(text=text, text_mask=text_mask, durations=durations,
                   pitch=pitch, energy=energy, audio=audio,
                   audio_lengths=audio_lengths)
        if spembs is not None:
            out["spembs"] = spembs
        return out


class _EpochPlan:
    """An :class:`FS2Batcher` with its eos id, read as
    ``data/iterator.py::EpochIterFactory`` reads a batcher."""

    def __init__(self, batcher: FS2Batcher, eos_id: int):
        self.batcher = batcher
        self.eos_id = eos_id

    def epoch_iterator(self, epoch: int, shard: tuple[int, int] = (0, 1),
                       rows=None):
        if shard != (0, 1) or rows is not None:
            raise NotImplementedError(
                "FastSpeech2 trains on one device, as in JAX (whose "
                "FS2Task.run has no mesh): its batches are not sharded")
        return self.batcher.epoch_iterator(epoch, self.eos_id)


def _fs2_inputs(model: FastSpeech2, frontend: LogMelFrontend, batch: dict):
    """(model keyword arguments, loss targets, text mask) of a batch on the
    front-end's device: the mel from the matmul-DFT front-end, cut to the
    model's ``max_feat_len``."""
    dev = frontend.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    mel, _ = frontend.fused(b["audio"], b["audio_lengths"])
    mel = mel[:, : model.config.max_feat_len]
    kw = dict(speech=mel if model.config.use_gst else None,
              spembs=b.get("spembs"), durations=b["durations"],
              pitch=b["pitch"], energy=b["energy"])
    targets = dict(mel=mel, durations=b["durations"], pitch=b["pitch"],
                   energy=b["energy"])
    return b["text"], b["text_mask"], kw, targets


def make_fs2_train_step(model: FastSpeech2, frontend: LogMelFrontend,
                        device=None):
    """``(state, batch, rng) -> (state, stats)`` for FastSpeech2 on
    ``device`` (cuda unless the caller asks for the CPU): the teacher-forced
    forward in training mode, :func:`fastspeech2_loss`, the gradients and
    the port's optimizer (clip -> Adam -> Noam).  ``stats`` holds the
    losses, ``grad_norm`` (before clipping) and ``notfinite_count`` as
    device tensors."""
    _check_device(frontend, device)

    def step(state: TrainState, batch: dict, rng):
        m = state.model
        m.train()
        text, text_mask, kw, targets = _fs2_inputs(m, frontend, batch)
        out = m(text, text_mask, generator=_generator(rng), **kw)
        losses = fastspeech2_loss(out, targets, text_mask)
        params = state.params
        grads = torch.autograd.grad(losses["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        stats = {k: v.detach() for k, v in losses.items()}
        stats["grad_norm"] = state.apply_gradients(grads)
        stats["notfinite_count"] = state.opt_state.notfinite_count
        return state, stats

    return step


def make_fs2_eval_step(model: FastSpeech2, frontend: LogMelFrontend,
                       device=None):
    """Validation ``(state, batch) -> losses``: eval mode, no gradients."""
    _check_device(frontend, device)

    def step(state: TrainState, batch: dict):
        m = state.model
        m.eval()
        with torch.no_grad():
            text, text_mask, kw, targets = _fs2_inputs(m, frontend, batch)
            return fastspeech2_loss(m(text, text_mask, **kw), targets,
                                    text_mask)

    return step


@dataclasses.dataclass
class FS2TaskConfig:
    """The JAX package's ``FS2TaskConfig`` field for field."""

    train_data_dir: str = ""
    valid_data_dir: str = ""
    token_list: str = ""
    # .npz of per-speaker x-vectors (models/xvector.py build_spk2xvector);
    # when set, batches carry spembs and the model conditions on them
    spk_xvector: str = ""
    exp_dir: str = "exp/fs2"
    frontend: LogMelConfig = dataclasses.field(default_factory=LogMelConfig)
    model: FastSpeech2Config = dataclasses.field(
        default_factory=FastSpeech2Config)
    batcher: FS2BatcherConfig = dataclasses.field(
        default_factory=FS2BatcherConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    trainer: TrainerConfig = dataclasses.field(
        default_factory=lambda: TrainerConfig(
            max_epoch=100, num_iters_per_epoch=None,
            best_model_criterion=("train", "loss", "min")))


def fs2_config_from_dict(data: dict) -> FS2TaskConfig:
    return _build(FS2TaskConfig, data, "config")


def load_fs2_config(path: str, overrides: Optional[list[str]] = None
                    ) -> FS2TaskConfig:
    """A config file (``configs/fs2_conformer_24k.yaml``, or an FS2
    experiment's ``config.yaml``) with ``a.b.c=value`` overrides."""
    data = yaml_subset.load_file(path) or {}
    return fs2_config_from_dict(apply_overrides(data, overrides or []))


class FS2Task:
    """FastSpeech2 training with MLMTask's experiment layout (config.yaml,
    tokens.txt, checkpoints/), so a trained duration predictor plugs into
    speech editing (``inference/durations.py::load_duration_fn``)."""

    @classmethod
    def build_token_converter(cls, cfg: FS2TaskConfig) -> TokenIDConverter:
        if cfg.token_list and os.path.exists(cfg.token_list):
            return TokenIDConverter(cfg.token_list)
        texts = read_2column_text(
            os.path.join(cfg.train_data_dir, "text")).values()
        return TokenIDConverter(build_token_list(texts))

    @classmethod
    def model_config(cls, cfg: FS2TaskConfig,
                     vocab_size: int) -> FastSpeech2Config:
        # eos is an extra trailing id (fastspeech2.py:539-541: eos = idim-1)
        return dataclasses.replace(cfg.model, idim=vocab_size + 1,
                                   odim=cfg.frontend.n_mels)

    @classmethod
    def build_model(cls, cfg: FS2TaskConfig, vocab_size: int,
                    device=None) -> FastSpeech2:
        """The model with seeded random weights (``trainer.seed``)."""
        return build_fs2(cls.model_config(cfg, vocab_size), device=device,
                         seed=cfg.trainer.seed)

    @classmethod
    def build(cls, cfg: FS2TaskConfig,
              device=None) -> tuple[Trainer, TrainState]:
        """Write config.yaml and tokens.txt to ``exp_dir`` and assemble the
        trainer and the initial state on ``device`` (cuda unless the caller
        asks for the CPU).  FastSpeech2 trains on one device, as in JAX:
        in a group of several processes this raises."""
        if world() > 1:
            raise NotImplementedError(
                "FastSpeech2 trains on one device, as in JAX (whose "
                "FS2Task.run has no mesh)")
        dev = resolve_device(device)
        os.makedirs(cfg.exp_dir, exist_ok=True)
        save_config(cfg, os.path.join(cfg.exp_dir, "config.yaml"))
        conv = cls.build_token_converter(cfg)
        conv.save(os.path.join(cfg.exp_dir, "tokens.txt"))

        model = cls.build_model(cfg, len(conv), dev)
        eos_id = model.config.idim - 1
        spk2xv = load_spk2xvector(cfg.spk_xvector) if cfg.spk_xvector \
            else None

        def factory(data_dir, num_iters):
            batcher = FS2Batcher(A3TDataset(data_dir, conv), cfg.frontend,
                                 cfg.batcher, spk2xvector=spk2xv)
            transfer = DeviceTransfer(dev) if dev.type == "cuda" else None
            return EpochIterFactory(_EpochPlan(batcher, eos_id), num_iters,
                                    prefetch=2, transfer=transfer)

        fe = LogMelFrontend(cfg.frontend, device=dev)
        state = create_train_state(model, make_optimizer(cfg.optim), dev)
        logger.info("FastSpeech2 params: %.2fM",
                    sum(p.numel() for p in model.parameters()) / 1e6)
        max_len = model.config.max_feat_len
        trainer = Trainer(
            cfg.trainer,
            make_fs2_train_step(model, fe, device=dev),
            make_fs2_eval_step(model, fe, device=dev),
            factory(cfg.train_data_dir, cfg.trainer.num_iters_per_epoch),
            factory(cfg.valid_data_dir, None) if cfg.valid_data_dir
            else None,
            CheckpointManager(os.path.join(cfg.exp_dir, "checkpoints"),
                              keep_nbest=cfg.trainer.keep_nbest_models,
                              criterion=cfg.trainer.best_model_criterion),
            batch_shape=lambda b: (int(b["text"].shape[0]), max_len))
        return trainer, state

    @classmethod
    def run(cls, cfg: FS2TaskConfig,
            device=None) -> tuple[Trainer, TrainState]:
        """Train; returns the trainer and the final state."""
        trainer, state = cls.build(cfg, device)
        return trainer, trainer.run(state)

    @classmethod
    def build_model_from_dir(cls, exp_dir: str, which: str = "ave",
                             device=None):
        """(model, config, tokens) from a training run, the model in eval
        mode on ``device`` (cuda unless the caller asks for the CPU):
        ``which`` "ave" (the n-best average with the latest epoch's
        BatchNorm statistics), "best"/"latest" or "epoch_N".  The directory
        is the port's or the JAX package's (orbax checkpoints, carried by
        ``fs2_state``; ``train/checkpoint.py::experiment_state``)."""
        dev = resolve_device(device)
        cfg = load_fs2_config(os.path.join(exp_dir, "config.yaml"))
        conv = TokenIDConverter(os.path.join(exp_dir, "tokens.txt"))
        model = FastSpeech2(cls.model_config(cfg, len(conv)))
        state = experiment_state(os.path.join(exp_dir, "checkpoints"), which,
                                 fs2_state)
        model.load_state_dict(state, strict=True)
        return model.to(dev).eval(), cfg, conv
