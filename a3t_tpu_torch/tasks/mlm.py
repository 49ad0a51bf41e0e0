"""MLM (A3T pretraining) task assembly: the port of ``a3t_tpu/tasks/mlm.py``
(the reference's MLMTask, espnet2/tasks/mlm.py:107-680).

Wires token list -> model -> optimizer -> batcher and iterators -> train
step -> trainer on one device, and rebuilds a trained model from its
experiment directory (``build_model_from_dir``, the reference's
build_model_from_file, tasks/mlm.py:446-496).  :meth:`MLMTask.build`
returns the trainer and the initial state, so that a caller can hand in
its own state; :meth:`MLMTask.run` builds and trains.

The training data is a data directory, record shards (a directory with an
``index.npz``, ``data/records.py``) or, with ``corpora``, a mixture of
corpora (``data/multi_corpus.py``), each with its own front-end and
``speech_only`` flag.  ``speech_only`` trains on audio alone.  With
``batcher.device_audio`` and record shards the flat corpus is uploaded to
the device once and each batch's audio is gathered there.
``trainer.steps_per_dispatch = k > 1`` takes k steps per call on chained
groups of batches (``make_chained_train_step``); like JAX it falls back to
1, with a warning, for a mixture or the duration-aware variant.  A
speaker-conditioned model (``model.spemb_dim > 0``) takes its batches'
x-vectors from :meth:`MLMTask._build_spemb_map`.  The duration-aware
variant (``model.duration_predictor_layers > 0``) trains through
``make_tts_train_step`` on batches with ``duration_collect`` on (training
batches only, as in JAX).  ``num_plot_examples > 0`` with a validation
set writes per-epoch mel and attention plots of the validation set's first
batch to ``exp_dir/plots`` (``train/plots.py``).

The JAX mesh is one process per card (``parallel/``): a group of ``dp *
sp * tp`` processes laid out as ``(data, seq, model)``, rank ``(d * sp +
s) * tp + t``.  Every rank builds the same
unsharded plan with bucket batch sizes at ``batch_multiple = dp`` (JAX's
``batch_multiple=dp``), takes its data rank's row block of every training
and validation batch on its own card (``cuda:{rank mod cards}``), uploads
a device-resident corpus whole, holds its model-axis slice of a Conformer
model (``mesh.tensor_parallel``: the heads and feed-forward units split
over tp ranks), steps on its seq rank's frame block of each row
(``mesh.sequence_parallel``: context parallelism, every frame bucket a
multiple of sp) through the rank-aware step, optimizer, trainer and
checkpoints; chained dispatch falls back to one step per call, as JAX's
does on a mesh.  Rank 0 alone writes ``config.yaml``, ``tokens.txt``, the
checkpoints, the plots and the tensorboard and wandb logs; the plots'
forward runs whole on every rank of data rank 0.  The longformer takes
both axes at every frame block JAX takes: JAX's two rules, each frame
bucket a multiple of half-window x dilation (checked when the task is
built) and of sp (checked at each step).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

import torch

from a3t_tpu_torch.compat.from_jax import mlm_state
from a3t_tpu_torch.data.batcher import BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.iterator import DeviceTransfer, EpochIterFactory
from a3t_tpu_torch.data.multi_corpus import (CorpusSpec,
                                             MultiCorpusIterFactory,
                                             make_multi_corpus_train_step)
from a3t_tpu_torch.data.records import RecordDataset
from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.parallel.mesh import (barrier, data_rank, make_mesh,
                                         rank, rank_device, world)
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models.mlm import A3TMLMModel, build_model
from a3t_tpu_torch.tasks.config import (A3TTaskConfig, _build, load_config,
                                        save_config)
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train.checkpoint import (CheckpointManager,
                                            experiment_state)
from a3t_tpu_torch.train.optim import make_optimizer
from a3t_tpu_torch.train.plots import make_attention_plot_fn, make_mel_plot_fn
from a3t_tpu_torch.train.train_step import (TrainState, create_train_state,
                                            make_chained_train_step,
                                            make_eval_step, make_train_step,
                                            make_tts_train_step)
from a3t_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("a3t_tpu_torch")


def _peek_batch(factory, epoch: int = 0):
    """The first batch of an epoch, releasing the iterator's prefetch
    queue (JAX tasks/mlm.py:43-50)."""
    it = factory(epoch)
    batch = next(iter(it))
    if hasattr(it, "close"):
        it.close()
    return batch


def check_supported(cfg: A3TTaskConfig) -> int:
    """Raise for what the port's task does not do yet; lay the group out
    as the config's mesh (``parallel.mesh.make_mesh``) and return the data
    axis's size."""
    m = cfg.mesh
    tp, sp = int(m.tensor_parallel), int(m.sequence_parallel)
    for stack in (cfg.model.encoder, cfg.model.decoder):
        if stack is not None:
            stack.check_supported(tp)
    # longformer buckets must be multiples of the half-window (the
    # pad_to_longformer_att_window invariant, collate_fn.py:241-247)
    enc = cfg.model.encoder
    if enc.selfattention_layer_type == "longformer":
        c, dl = enc.attention_window // 2, max(enc.attention_dilation, 1)
        bad = [b for b in cfg.batcher.bucket_frames if b % (c * dl) != 0]
        if bad:
            raise ValueError(
                f"bucket_frames {bad} not multiples of half-window x "
                f"dilation {c * dl} (required by longformer attention)")
    return make_mesh(m.data_parallel, tp, sp)


class MLMTask:
    @classmethod
    def build_token_converter(cls, cfg: A3TTaskConfig,
                              write: bool = True) -> TokenIDConverter:
        """The token list of ``cfg.token_list``, or one built from the
        training text and saved there when ``write``."""
        if cfg.token_list and os.path.exists(cfg.token_list):
            return TokenIDConverter(cfg.token_list)
        # build from the training text (recipe stage 5, mlm.sh:257-260)
        texts = read_2column_text(
            os.path.join(cfg.train_data_dir, "text")).values()
        conv = TokenIDConverter(build_token_list(texts))
        if cfg.token_list and write:
            conv.save(cfg.token_list)
        return conv

    @classmethod
    def build_frontend(cls, cfg: A3TTaskConfig, device=None) -> LogMelFrontend:
        return LogMelFrontend(cfg.frontend, device=device)

    @classmethod
    def build_normalizer(cls, cfg: A3TTaskConfig):
        if cfg.normalize == "global_mvn":
            from a3t_tpu_torch.dsp.normalize import GlobalMVN

            return GlobalMVN.from_stats(cfg.stats_file)
        if cfg.normalize == "utterance_mvn":
            from a3t_tpu_torch.dsp.normalize import UtteranceMVN

            return UtteranceMVN()
        if cfg.normalize != "none":
            raise ValueError(f"unknown normalize {cfg.normalize!r}")
        return None

    @classmethod
    def build_model(cls, cfg: A3TTaskConfig, vocab_size: int,
                    device=None) -> A3TMLMModel:
        """The model with seeded random weights (``trainer.seed``)."""
        model_cfg = dataclasses.replace(cfg.model, vocab_size=vocab_size,
                                        odim=cfg.frontend.n_mels)
        return build_model(model_cfg, device=device, seed=cfg.trainer.seed)

    @classmethod
    def build_batcher(cls, cfg: A3TTaskConfig, data_dir: str,
                      conv: TokenIDConverter, train: bool,
                      batch_multiple: int = 1) -> BucketBatcher:
        """The batcher of a data directory or of record shards (a
        directory with an ``index.npz``).  Validation batches carry their
        audio: only the train step reads the corpus on the device.
        ``batch_multiple > 1`` (the data axis's size) replaces the
        config's."""
        if os.path.exists(os.path.join(data_dir, "index.npz")):
            ds = RecordDataset(data_dir, speech_only=cfg.speech_only)
        else:
            ds = A3TDataset(data_dir, conv, speech_only=cfg.speech_only)
        bcfg = cfg.batcher
        if not train:
            bcfg = dataclasses.replace(bcfg, mlm_prob_factor=1.0,
                                       device_audio=False)
        if batch_multiple > 1:
            bcfg = dataclasses.replace(bcfg, batch_multiple=batch_multiple)
        if cfg.model.duration_predictor_layers > 0 and train:
            # the duration-aware variant collects durations (JAX
            # tasks/mlm.py:107-110)
            bcfg = dataclasses.replace(bcfg, duration_collect=True)
        spemb_map = None
        if cfg.model.spemb_dim > 0:
            spemb_map = cls._build_spemb_map(cfg, ds, data_dir)
        return BucketBatcher(ds, cfg.frontend, bcfg, spemb_map=spemb_map)

    @classmethod
    def _build_spemb_map(cls, cfg: A3TTaskConfig, ds: A3TDataset,
                         data_dir: str) -> dict:
        """uid -> x-vector for a speaker-conditioned model
        (``a3t_tpu/tasks/mlm.py:116-164``).  Each uid resolves, in order,
        from ``<data_dir>/utt2xvector.npz`` (per-utterance embeddings,
        ``models/xvector.py::build_utt2xvector``), then ``cfg.spemb_file``
        by uid, then ``cfg.spemb_file`` by speaker (``utt2spk``).  A uid
        that resolves nowhere raises: a silent zero vector would train the
        conditioning to be ignored."""
        local_path = os.path.join(data_dir, "utt2xvector.npz")
        local = table = {}
        if os.path.exists(local_path):
            with np.load(local_path) as f:
                local = {k: np.asarray(f[k], np.float32) for k in f.files}
        if cfg.spemb_file:
            with np.load(cfg.spemb_file) as f:
                table = {k: np.asarray(f[k], np.float32) for k in f.files}
        if not local and not table:
            raise ValueError(
                f"model.spemb_dim > 0 but neither {local_path} nor "
                "spemb_file provides embeddings")
        utt2spk_path = os.path.join(data_dir, "utt2spk")
        utt2spk = (read_2column_text(utt2spk_path)
                   if os.path.exists(utt2spk_path) else {})
        spemb_map, missing = {}, []
        for uid in ds.uids:
            if uid in local:
                spemb_map[uid] = local[uid]
            elif uid in table:
                spemb_map[uid] = table[uid]
            else:
                spk = utt2spk.get(uid)
                if spk is None:
                    spk = ds.get_meta(uid).get("speaker")
                if spk in table:
                    spemb_map[uid] = table[spk]
                else:
                    missing.append(uid)
        if missing:
            raise ValueError(
                f"no speaker embedding for {len(missing)} utts of "
                f"{data_dir} (first: {missing[:3]})")
        return spemb_map

    @classmethod
    def build(cls, cfg: A3TTaskConfig, device=None,
              shard: tuple[int, int] = (0, 1)) -> tuple[Trainer, TrainState]:
        """Write config.yaml and tokens.txt to ``exp_dir`` and assemble the
        trainer and the initial train state on ``device`` (cuda unless the
        caller asks for the CPU; over several ranks, this rank's card)."""
        w = check_supported(cfg)  # the data axis's size
        r = rank()
        dev = rank_device(device)
        rows = (data_rank(), w) if w > 1 else None

        os.makedirs(cfg.exp_dir, exist_ok=True)
        if r == 0:
            conv = cls.build_token_converter(cfg)
            save_config(cfg, os.path.join(cfg.exp_dir, "config.yaml"))
            conv.save(os.path.join(cfg.exp_dir, "tokens.txt"))
        barrier()  # a token list that rank 0 built is whole on disk
        if r != 0:
            conv = cls.build_token_converter(cfg, write=False)
        transfer = DeviceTransfer(dev) if dev.type == "cuda" else None

        chain = int(cfg.trainer.steps_per_dispatch)
        if chain > 1 and (world() > 1 or cfg.corpora
                          or cfg.model.duration_predictor_layers > 0):
            logger.warning(
                "steps_per_dispatch=%d unsupported with mesh/multi-corpus/"
                "TTS training; falling back to 1", chain)
            chain = 1
        trainer_cfg = dataclasses.replace(cfg.trainer,
                                          steps_per_dispatch=chain)

        def factory(data_dir, train, num_iters, chain=1):
            batcher = cls.build_batcher(cfg, data_dir, conv, train,
                                        batch_multiple=w)
            return EpochIterFactory(batcher, num_iters, shard,
                                    cfg.num_workers_prefetch, transfer,
                                    chain=chain, rows=rows)

        model = cls.build_model(cfg, len(conv), dev)
        fe = cls.build_frontend(cfg, dev)
        normalizer = cls.build_normalizer(cfg)
        corpus = None
        if cfg.corpora:
            train_factory, train_step = cls._build_multi_corpus(
                cfg, conv, model, dev, shard, transfer, rows)
        else:
            train_factory = factory(cfg.train_data_dir, True,
                                    cfg.trainer.num_iters_per_epoch, chain)
            batcher = train_factory.batcher
            logger.info("train buckets: %s (%d utts dropped as overlong)",
                        [(b.n_frames, b.batch_size) for b in batcher.buckets],
                        batcher.n_dropped)
            if cfg.batcher.device_audio and hasattr(batcher.dataset,
                                                    "flat_pcm"):
                # the corpus on the device: uploaded once, each batch's
                # audio gathered there (train_step.gather_audio)
                pad = max(b.n_samples for b in batcher.buckets)
                flat = batcher.dataset.flat_pcm(pad_samples=pad)
                corpus = torch.from_numpy(flat).to(dev)
                logger.info("device-resident corpus: %.0f MB int16 PCM",
                            flat.nbytes / 1e6)
                del flat
            if cfg.model.duration_predictor_layers > 0:
                train_step = make_tts_train_step(model, fe, device=dev,
                                                 corpus=corpus)
            elif chain > 1:
                train_step = make_chained_train_step(
                    model, fe, chain, device=dev, normalizer=normalizer,
                    use_fused=cfg.use_fused_frontend, corpus=corpus,
                    speech_only=cfg.speech_only)
            else:
                train_step = make_train_step(
                    model, fe, device=dev, normalizer=normalizer,
                    use_fused=cfg.use_fused_frontend, corpus=corpus,
                    speech_only=cfg.speech_only)
        valid_factory = (factory(cfg.valid_data_dir, False, None)
                         if cfg.valid_data_dir else None)
        state = create_train_state(model, make_optimizer(cfg.optim), dev)
        logger.info("model params: %.2fM",
                    sum(p.numel() for p in model.parameters()) / 1e6)

        tb_writer = wandb_run = None
        if cfg.use_tensorboard and r == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                tb_writer = SummaryWriter(
                    os.path.join(cfg.exp_dir, "tensorboard"))
            except ImportError:  # tensorboard is optional
                logger.warning("tensorboard unavailable; skipping")
        if cfg.use_wandb and r == 0:
            try:
                import wandb

                wandb_run = wandb.init(
                    project=cfg.wandb_project,
                    name=os.path.basename(os.path.abspath(cfg.exp_dir)),
                    dir=cfg.exp_dir)
            except ImportError:  # wandb is optional
                logger.warning("wandb unavailable; skipping")

        plot_fn = None
        # rank 0 plots; the other ranks of its model group take part in the
        # forward's all-reduces (the forward runs whole, with no seq split,
        # on every seq rank of data rank 0)
        if cfg.num_plot_examples > 0 and valid_factory is not None \
                and data_rank() == 0:
            plot_batch = _peek_batch(valid_factory)
            plot_dir = os.path.join(cfg.exp_dir, "plots")
            plot_fns = (
                make_mel_plot_fn(fe, normalizer, plot_batch, plot_dir,
                                 n_examples=cfg.num_plot_examples,
                                 render=r == 0),
                make_attention_plot_fn(fe, normalizer, plot_batch, plot_dir,
                                       n_examples=cfg.num_plot_examples,
                                       render=r == 0))

            def plot_fn(state, epoch):
                return [f(state, epoch) for f in plot_fns]

        trainer = Trainer(
            trainer_cfg,
            train_step,
            make_eval_step(model, fe, device=dev, normalizer=normalizer,
                           speech_only=cfg.speech_only),
            train_factory,
            valid_factory,
            CheckpointManager(os.path.join(cfg.exp_dir, "checkpoints"),
                              keep_nbest=cfg.trainer.keep_nbest_models,
                              criterion=cfg.trainer.best_model_criterion),
            tensorboard_writer=tb_writer,
            wandb_run=wandb_run,
            plot_fn=plot_fn,
        )
        return trainer, state

    @classmethod
    def _build_multi_corpus(cls, cfg: A3TTaskConfig, conv: TokenIDConverter,
                            model: A3TMLMModel, dev, shard, transfer,
                            rows=None):
        """(train factory, train step) of a ``corpora`` mixture (JAX
        tasks/mlm.py:399-434): each entry ``{name, data_dir, portion,
        speech_only, frontend}`` gets its own batcher on its own front-end
        (the config's when it has none); the step dispatches each
        ``(name, batch)`` to its corpus's step.  ``rows = (r, W)``: each
        batcher at ``batch_multiple = max(W, the config's)`` and rank r's
        row blocks."""
        specs, frontends, speech_only = [], {}, {}
        for entry in cfg.corpora:
            entry = dict(entry)
            name = entry["name"]
            fe_cfg = (_build(LogMelConfig, entry["frontend"],
                             f"corpora.{name}.frontend")
                      if entry.get("frontend") else cfg.frontend)
            so = bool(entry.get("speech_only", False))
            ds = A3TDataset(entry["data_dir"], conv, speech_only=so)
            bcfg = cfg.batcher
            if rows is not None:
                bcfg = dataclasses.replace(bcfg, batch_multiple=max(
                    rows[1], bcfg.batch_multiple))
            batcher = BucketBatcher(ds, fe_cfg, bcfg)
            logger.info("corpus %s (portion %s%s, %d Hz): buckets %s (%d "
                        "utts dropped as overlong)", name,
                        entry.get("portion", 1.0),
                        ", speech only" if so else "", fe_cfg.fs,
                        [(b.n_frames, b.batch_size) for b in batcher.buckets],
                        batcher.n_dropped)
            specs.append(CorpusSpec(name, batcher,
                                    float(entry.get("portion", 1.0)),
                                    speech_only=so))
            frontends[name] = LogMelFrontend(fe_cfg, device=dev)
            speech_only[name] = so
        factory = MultiCorpusIterFactory(
            specs, cfg.trainer.num_iters_per_epoch or 100, shard,
            prefetch=cfg.num_workers_prefetch, transfer=transfer, rows=rows)
        return factory, make_multi_corpus_train_step(
            model, frontends, speech_only, device=dev)

    @classmethod
    def run(cls, cfg: A3TTaskConfig, device=None,
            shard: tuple[int, int] = (0, 1)) -> tuple[Trainer, TrainState]:
        """Full training (the reference's main_worker,
        abs_task.py:1048-1299); returns the trainer and the final state."""
        trainer, state = cls.build(cfg, device, shard)
        return trainer, trainer.run(state)

    @classmethod
    def build_model_from_dir(cls, exp_dir: str, which: str = "ave",
                             device=None):
        """(model, config, tokens) from a training run's directory, the
        model in eval mode on ``device`` (cuda unless the caller asks for
        the CPU).

        ``which``: "ave" (the n-best averaged parameters, the file inference
        uses, sedit_inference.py:352, with the BatchNorm statistics of the
        latest epoch), "best"/"latest" (the latest epoch) or "epoch_N".
        The directory is the port's or the JAX package's (orbax
        checkpoints, carried by ``mlm_state``;
        ``train/checkpoint.py::experiment_state``)."""
        dev = resolve_device(device)
        cfg = load_config(os.path.join(exp_dir, "config.yaml"))
        conv = TokenIDConverter(os.path.join(exp_dir, "tokens.txt"))
        model = cls.build_model(cfg, len(conv), dev)
        state = experiment_state(os.path.join(exp_dir, "checkpoints"), which,
                                 mlm_state)
        model.load_state_dict(state, strict=True)
        return model.eval(), cfg, conv

