"""The A3T training step (``a3t_tpu/train/train_step.py``).

``create_train_state`` -> ``make_train_step(model, frontend)`` ->
``step(state, batch, rng)``, the calls the JAX package's bench makes: raw
audio enters the device, the log-mel front-end produces features, the
Conformer MLM model computes the masked L1 loss, and the optimizer applies
clip -> Adam -> Noam.  On the card every attention block's forward and
backward run through hand-written kernels: K1 and K2 for rel-pos attention
(the 24 kHz config), K3, K4 and K5 for windowed attention (the 16 kHz
longformer config, whose frame buckets must be multiples of the half-window,
as ``a3t_tpu/tasks/mlm.py:338-347`` requires).  :func:`make_tts_train_step`
is the duration-aware variant's step (``a3t_tpu/train/train_step.py:
336-414``) and :func:`make_chained_train_step` takes k steps per call on
a stacked group of same-bucket batches (``steps_per_dispatch``).

Batches are dicts of host (numpy) or torch arrays, as in the JAX package:

    audio              (B, S)   float32 (or int16 PCM)  raw waveform
    audio_lengths      (B,)     int32
    text               (B, T)   int32     phone ids (0 = pad)
    text_mask          (B, T)   bool
    masked_position    (B, F)   bool      F = 1 + S // hop
    speech_segment_pos (B, F)   int32
    text_segment_pos   (B, T)   int32

A batch may carry ``audio_offset`` (B,) in place of ``audio``: the
waveforms are then gathered from a flat int16 corpus tensor on the device
(:func:`gather_audio`), given to ``featurize`` and the steps as ``corpus``.
A step built with ``frontend=None`` takes batches already featurized (the
model's inputs: ``speech``, ``speech_mask``, ...) and skips ``featurize``.
``speech_only=True`` gives the model speech-only batches' segment
embeddings.

Differences from the JAX step: the state is updated in place and returned
(the JAX step donates its state); ``rng`` is an int seed or a CPU
``torch.Generator`` from which every dropout site draws its seed on the
host.

Over the W ranks of the data axis (``parallel/``, one process per card)
each rank steps on its row block of the global batch; the steps keep the
JAX mesh's single-controller semantics: the masked means divide by the
global batch's count, BatchNorm reduces its statistics over the data
group, the optimizer sums the gradients (ZeRO-1, ``train/optim.py``), and
every statistic is the global batch's, equal on every rank.  The tp ranks
of the model axis step on the same rows with their slices of the model
(``models/mlm.py``), so the statistics are summed over the data group
alone.  On the seq axis (context parallelism) the front-end stays whole,
replicated over the seq group as in JAX, and
:func:`constrain_time_sharding` then gives each seq rank its frame block
of the model's inputs and of the loss's target (``parallel/
sequence.py``); the masked means and the statistics are summed over the
data and seq groups, and the optimizer sums the gradients over both.  The
chained step takes one process only, as JAX's mesh step has no chained
form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.frontend import LogMelFrontend
from a3t_tpu_torch.models.layers import duration_loss
from a3t_tpu_torch.models.mlm import A3TMLMModel, mlm_loss
from a3t_tpu_torch.ops.fused_logmel import fused_logmel
from a3t_tpu_torch.parallel.mesh import (all_reduce_sum, data_world,
                                         seq_world, world)
from a3t_tpu_torch.parallel.sequence import frame_block, seq_layout
from a3t_tpu_torch.parallel.sharding import FlatLayout
from a3t_tpu_torch.train.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """step (host int), the model (its parameters and BatchNorm running
    statistics), the optimizer's state and, for a model-axis rank's slice
    of the model, where its parameters lie in the whole model's
    (``FlatLayout``)."""

    step: int
    model: A3TMLMModel
    opt_state: OptState
    tx: Optimizer
    layout: FlatLayout = None

    @property
    def params(self) -> list:
        return list(self.model.parameters())

    def apply_gradients(self, grads) -> torch.Tensor:
        """Update the parameters in place; returns the gradients' global
        norm.  The step count moves even when the update is skipped."""
        g_norm = self.tx.apply(self.params, grads, self.opt_state,
                               self.layout)
        self.step += 1
        return g_norm


def create_train_state(model: A3TMLMModel, tx: Optimizer,
                       device=None) -> TrainState:
    """Move ``model`` (with its initial weights) to ``device`` (cuda unless
    the caller asks for the CPU) and start the optimizer's state there,
    laid out like the model's slice of the model axis."""
    model.to(resolve_device(device))
    return TrainState(step=0, model=model, opt_state=tx.init(
        model.parameters()), tx=tx, layout=FlatLayout.of(model))


def gather_audio(corpus: torch.Tensor, batch: dict,
                 hop_length: int) -> torch.Tensor:
    """The (B, S) audio of a batch from the flat int16 ``corpus`` on the
    device (``a3t_tpu/train/train_step.py:70-91``): S = (F - 1) * hop
    samples from each ``audio_offset``, zero past each ``audio_lengths``.
    As JAX's ``dynamic_slice``, an offset is clamped so that its slice lies
    inside the corpus."""
    n_frames = batch["masked_position"].shape[1]
    n_samples = (n_frames - 1) * hop_length
    if corpus.dim() != 1 or corpus.shape[0] < n_samples:
        raise ValueError(f"corpus {tuple(corpus.shape)} holds no slice of "
                         f"{n_samples} samples")
    dev = corpus.device
    offsets = torch.as_tensor(batch["audio_offset"], device=dev).to(
        torch.int64).clamp(0, corpus.shape[0] - n_samples)
    pos = torch.arange(n_samples, device=dev)
    audio = corpus[offsets[:, None] + pos[None, :]]
    valid = pos[None, :] < torch.as_tensor(batch["audio_lengths"],
                                           device=dev)[:, None]
    return torch.where(valid, audio, torch.zeros((), dtype=audio.dtype,
                                                 device=dev))


def featurize(frontend: LogMelFrontend, batch: dict, use_fused: bool = True,
              use_pallas: bool = False, normalizer=None,
              corpus=None) -> dict:
    """Raw-audio batch -> model input batch on the front-end's device
    (``a3t_tpu/train/train_step.py:94-160``).

    ``use_fused=True`` (the default) runs the matmul-DFT front-end,
    ``use_fused=False`` the rfft one; ``use_pallas=True`` runs the fused
    log-mel kernel (K6, ``ops/fused_logmel.py``) instead of either.  A batch
    with ``audio_offset`` takes its waveforms from ``corpus``; int16 audio is
    dequantized by 1/32768.  ``normalizer`` (e.g. GlobalMVN) applies to the
    features; ``spemb`` passes through.
    """
    dev = frontend.device
    if "audio_offset" in batch:
        if corpus is None:
            raise ValueError(
                "batch has audio_offset (device_audio batcher) but no "
                "corpus buffer was provided to featurize/make_train_step")
        audio = gather_audio(corpus, batch,
                             frontend.config.hop_length).to(dev)
    else:
        audio = torch.as_tensor(batch["audio"], device=dev)
    if audio.dtype == torch.int16:
        # int16 PCM (data/batcher.py audio_int16); dequantize on device
        audio = audio.to(torch.float32) * (1.0 / 32768.0)
    lengths = torch.as_tensor(batch["audio_lengths"], device=dev)
    if use_pallas:
        feats, flens = fused_logmel(
            audio.to(torch.float32).contiguous(), frontend.config, lengths)
    else:
        fe = frontend.fused if use_fused else frontend
        feats, flens = fe(audio, lengths)
    if normalizer is not None:
        feats = normalizer(feats)
    n_f = feats.shape[1]
    speech_mask = torch.arange(n_f, device=dev)[None, :] < flens[:, None]
    # the reference multiplies the sampled mask by the non-pad mask
    # (collate_fn.py:381-382)
    out = {k: torch.as_tensor(batch[k], device=dev) for k in
           ("text", "text_mask", "speech_segment_pos", "text_segment_pos")}
    out["masked_position"] = torch.as_tensor(
        batch["masked_position"], device=dev) & speech_mask
    out = dict(speech=feats, speech_mask=speech_mask, **out)
    if "spemb" in batch:
        out["spemb"] = torch.as_tensor(batch["spemb"], device=dev)
    return out


def check_bucket(model: A3TMLMModel, n_frames: int) -> None:
    """Raise unless ``n_frames`` suits the model: a longformer model needs a
    multiple of its half-window (the pad_to_longformer_att_window rule,
    collate_fn.py:241-247)."""
    enc = model.config.encoder
    if enc.selfattention_layer_type == "longformer":
        c = (enc.attention_window // 2) * max(enc.attention_dilation, 1)
        if n_frames % c != 0:
            raise ValueError(f"{n_frames} frames is not a multiple of "
                             f"half-window x dilation {c} (required by "
                             f"longformer attention)")


# the featurized batch's (B, F, ...) entries, whose frames the seq axis
# splits (JAX constrain_time_sharding); the rest (text, spemb) stay whole
TIME_KEYS = ("speech", "masked_position", "speech_mask",
             "speech_segment_pos", "durations")


def constrain_time_sharding(mb: dict, seq) -> dict:
    """This seq rank's frame block of every frame-wise entry of the model
    inputs ``mb`` (``a3t_tpu/train/train_step.py:149-181``); ``mb`` itself
    for a layout of None (sp = 1)."""
    if seq is None:
        return mb
    return {k: frame_block(v, seq) if k in TIME_KEYS else v
            for k, v in mb.items()}


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def _check_device(frontend: Optional[LogMelFrontend], device,
                  model: Optional[torch.nn.Module] = None) -> torch.device:
    """The step's device; the front-end (or, without one, the model)
    must be on it."""
    dev = resolve_device(device)
    where = (frontend.device if frontend is not None
             else next(model.parameters()).device)
    # a parameter's device carries its index (cuda:0), the step's may not
    if where.type != dev.type or dev.index not in (None, where.index):
        raise ValueError(f"the {'front-end' if frontend else 'model'} runs "
                         f"on {where}, the step on {dev}")
    return dev


def _model_inputs(frontend, batch: dict, dev, **kw) -> dict:
    """``featurize`` the batch, or with no front-end take it as the
    model's inputs, on ``dev``."""
    if frontend is not None:
        return featurize(frontend, batch, **kw)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_train_step(model: A3TMLMModel, frontend: Optional[LogMelFrontend],
                    device=None, normalizer=None, use_fused: bool = True,
                    corpus=None, speech_only: bool = False):
    """Build the train step ``(state, batch, rng) -> (state, stats)`` on
    ``device`` (cuda unless the caller asks for the CPU).  ``normalizer``,
    ``use_fused`` and ``corpus`` go to :func:`featurize` (the matmul-DFT
    front-end by default, as in JAX); ``frontend=None`` takes featurized
    batches.

    ``stats`` holds device tensors: ``loss``, ``loss_mlm``,
    ``masked_frames``, ``grad_norm`` (before clipping) and
    ``notfinite_count``.  BatchNorm running statistics move in the forward,
    as the JAX step's ``batch_stats`` do, also on a skipped step.
    """
    dev = _check_device(frontend, device, model)
    use_mse = model.config.use_mse_loss
    has_duration = model.config.duration_predictor_layers > 0

    def step(state: TrainState, batch: dict, rng):
        m = state.model
        m.train()
        mb = _model_inputs(frontend, batch, dev, use_fused=use_fused,
                           normalizer=normalizer, corpus=corpus)
        check_bucket(m, mb["speech"].shape[1])
        seq = seq_layout(mb["speech"].shape[1])
        mb = constrain_time_sharding(mb, seq)
        before, after, log_d = m(**mb,
                                 generator=_generator(rng),
                                 return_log_durations=True,
                                 speech_only=speech_only, seq=seq)
        loss = mlm_loss(before, after, mb["speech"], mb["masked_position"],
                        use_mse=use_mse)
        stats = {"loss_mlm": loss.detach()}
        if has_duration and "durations" in batch:
            # the duration term over the masked frames (JAX :216-221)
            dl = _masked_mean(duration_loss(log_d, frame_block(
                torch.as_tensor(batch["durations"], device=log_d.device),
                seq)), mb["masked_position"])
            loss = loss + dl
            stats["loss_duration"] = dl.detach()
        grad_norm = _update(state, loss)
        stats = _global({**stats, "loss": loss.detach(),
                         "masked_frames": mb["masked_position"].sum()})
        return state, {**stats, "grad_norm": grad_norm,
                       "notfinite_count": state.opt_state.notfinite_count}

    return step


def make_chained_train_step(model: A3TMLMModel,
                            frontend: Optional[LogMelFrontend], k: int,
                            device=None, normalizer=None,
                            use_fused: bool = True, corpus=None,
                            speech_only: bool = False):
    """``k`` optimizer steps per call (``steps_per_dispatch``; JAX
    ``make_chained_train_step``): ``(state, stacked, generators, valid) ->
    (state, stats)``.  Every array of ``stacked`` has a leading k axis
    (``data.batcher.stack_group``), ``generators[i]`` is sub-step i's
    dropout generator (or seed) and ``valid`` (k,) host booleans.  The
    sub-steps run in order through :func:`make_train_step`'s step; a
    sub-step with ``valid[i]`` False is skipped, which equals the JAX scan's
    computing it and keeping the old state.  ``stats`` holds each
    statistic stacked over the k sub-steps, zero at the skipped ones.
    The duration-aware variant and world sizes above 1 raise, as in JAX
    (whose mesh step has no chained form)."""
    if world() > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 is not wired for a step on a mesh")
    if model.config.duration_predictor_layers > 0:
        raise NotImplementedError(
            "steps_per_dispatch > 1 is not wired for the duration/TTS "
            "train step")
    inner = make_train_step(model, frontend, device=device,
                            normalizer=normalizer, use_fused=use_fused,
                            corpus=corpus, speech_only=speech_only)

    def step(state: TrainState, stacked: dict, generators, valid):
        per_step = [None] * k
        for i in range(k):
            if valid[i]:
                state, per_step[i] = inner(
                    state, {key: v[i] for key, v in stacked.items()},
                    generators[i])
        first = next(s for s in per_step if s is not None)
        stats = {key: torch.stack([
            torch.zeros_like(first[key]) if s is None else s[key]
            for s in per_step]) for key in first}
        return state, stats

    return step


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ``mask``, whose count is the global batch's
    over the data and seq ranks (each rank's share then sums to the global
    mean)."""
    w = mask.to(torch.float32)
    return (x * w).sum() / (all_reduce_sum(w.sum(), "data_seq") + 1e-10)


def _global(stats: dict) -> dict:
    """The global batch's statistics from the data and seq ranks' shares
    (sums; one all_reduce over the data x seq group), each in its own
    dtype; ``stats`` itself where both axes have size 1."""
    if data_world() * seq_world() == 1:
        return stats
    keys = list(stats)
    total = all_reduce_sum(torch.stack([stats[k].float() for k in keys]),
                           "data_seq")
    return {k: total[i].to(stats[k].dtype) for i, k in enumerate(keys)}


def _update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Gradients of ``loss`` (zeros for parameters it does not reach)
    applied to the state; returns their global norm."""
    params = state.params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return state.apply_gradients(grads)


def tts_inputs(mb: dict, batch: dict) -> dict:
    """The duration-aware variant's reduced inputs (JAX train_step.py:
    361-379): the featurized batch ``mb`` gathered by the host batch's
    ``reordered_index``; a reduced position is valid when it lies before
    ``reduced_lengths`` and its frame is valid; ``durations`` gathered the
    same way."""
    dev = mb["speech"].device
    n_f = mb["speech"].shape[1]
    ri = torch.as_tensor(batch["reordered_index"], device=dev).long()

    def red(x):
        return torch.gather(x, 1, ri)

    valid = (torch.arange(n_f, device=dev)[None, :]
             < torch.as_tensor(batch["reduced_lengths"], device=dev)[:, None]
             ) & red(mb["speech_mask"])
    return dict(
        speech=torch.gather(mb["speech"], 1, ri[..., None].expand(
            -1, -1, mb["speech"].shape[2])),
        text=mb["text"],
        masked_position=red(mb["masked_position"]) & valid,
        speech_mask=valid,
        text_mask=mb["text_mask"],
        speech_segment_pos=red(mb["speech_segment_pos"]),
        text_segment_pos=mb["text_segment_pos"],
        durations=red(torch.as_tensor(batch["durations"], device=dev)))


def tts_loss(model: A3TMLMModel, mb: dict, batch: dict, generator=None):
    """(loss, mlm loss, duration loss) of the variant on the featurized
    batch ``mb`` of host batch ``batch``: :func:`mlm_loss` on the
    full-resolution mel and mask plus the duration loss averaged over the
    reduced masked positions, both over the global batch's counts.  On the
    seq axis the reduced inputs, the mel and the mask are the rank's frame
    blocks (the reduced sequence is gathered from the whole featurized
    batch first, which every rank holds)."""
    reduced = tts_inputs(mb, batch)
    n_f = mb["speech"].shape[1]
    red_seq = seq_layout(reduced["speech"].shape[1])
    out_seq = seq_layout(n_f)
    reduced = constrain_time_sharding(reduced, red_seq)
    before, after, log_d = model.tts_forward(
        **reduced, out_frames=n_f, generator=generator, seq=red_seq)
    loss_mlm = mlm_loss(before, after, frame_block(mb["speech"], out_seq),
                        frame_block(mb["masked_position"], out_seq),
                        use_mse=model.config.use_mse_loss)
    dl = _masked_mean(duration_loss(log_d, reduced["durations"]),
                      reduced["masked_position"])
    return loss_mlm + dl, loss_mlm, dl


def make_tts_train_step(model: A3TMLMModel, frontend: LogMelFrontend,
                        device=None, corpus=None):
    """The duration-aware variant's train step ``(state, batch, rng) ->
    (state, stats)`` (ESPnetMLMTTSModel, sedit_model.py:454-503; JAX
    ``make_tts_train_step``).  The batch carries the batcher's
    ``durations``, ``reordered_index`` and ``reduced_lengths``
    (``BatcherConfig.duration_collect``); :func:`tts_loss` gives the loss:
    ``tts_forward`` runs the encoder over the reduced sequence
    (:func:`tts_inputs`) and the decoder over the length-regulated frames.
    As in JAX, the step takes the matmul-DFT front-end and no normalizer,
    and gives the model no ``spemb``.  ``stats``: ``loss``, ``loss_mlm``,
    ``loss_duration``, ``grad_norm`` and ``notfinite_count``."""
    _check_device(frontend, device, model)

    def step(state: TrainState, batch: dict, rng):
        m = state.model
        m.train()
        mb = featurize(frontend, batch, corpus=corpus)
        loss, loss_mlm, dl = tts_loss(m, mb, batch, _generator(rng))
        grad_norm = _update(state, loss)
        stats = _global({"loss": loss.detach(), "loss_mlm": loss_mlm.detach(),
                         "loss_duration": dl.detach()})
        return state, {**stats, "grad_norm": grad_norm,
                       "notfinite_count": state.opt_state.notfinite_count}

    return step


def make_eval_step(model: A3TMLMModel, frontend: Optional[LogMelFrontend],
                   device=None, normalizer=None, speech_only: bool = False):
    """Validation step ``(state, batch) -> stats``: no gradients, running
    BatchNorm statistics, no dropout; the matmul-DFT front-end, as in
    JAX (``frontend=None``: featurized batches)."""
    dev = _check_device(frontend, device, model)
    use_mse = model.config.use_mse_loss

    def step(state: TrainState, batch: dict):
        m = state.model
        m.eval()
        with torch.no_grad():
            mb = _model_inputs(frontend, batch, dev, normalizer=normalizer)
            seq = seq_layout(mb["speech"].shape[1])
            mb = constrain_time_sharding(mb, seq)
            before, after = m(**mb, speech_only=speech_only, seq=seq)
            loss = mlm_loss(before, after, mb["speech"],
                            mb["masked_position"], use_mse=use_mse)
            loss = _global({"loss": loss})["loss"]
        return {"loss": loss, "loss_mlm": loss}

    return step
