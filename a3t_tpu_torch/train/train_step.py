"""The A3T training step (``a3t_tpu/train/train_step.py``).

``create_train_state`` -> ``make_train_step(model, frontend)`` ->
``step(state, batch, rng)``, the calls the JAX package's bench makes: raw
audio enters the device, the log-mel front-end produces features, the
Conformer MLM model computes the masked L1 loss, and the optimizer applies
clip -> Adam -> Noam.  On the card every attention block's forward and
backward run through hand-written kernels: K1 and K2 for rel-pos attention
(the 24 kHz config), K3, K4 and K5 for windowed attention (the 16 kHz
longformer config, whose frame buckets must be multiples of the half-window,
as ``a3t_tpu/tasks/mlm.py:338-347`` requires).

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

Differences from the JAX step: the state is updated in place and returned
(the JAX step donates its state); ``rng`` is an int seed or a CPU
``torch.Generator`` from which every dropout site draws its seed on the
host.  Mesh sharding, chained dispatch and the TTS step are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.frontend import LogMelFrontend
from a3t_tpu_torch.models.mlm import A3TMLMModel, mlm_loss
from a3t_tpu_torch.ops.fused_logmel import fused_logmel
from a3t_tpu_torch.train.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """step (host int), the model (its parameters and BatchNorm running
    statistics) and the optimizer's state."""

    step: int
    model: A3TMLMModel
    opt_state: OptState
    tx: Optimizer

    @property
    def params(self) -> list:
        return list(self.model.parameters())

    def apply_gradients(self, grads) -> torch.Tensor:
        """Update the parameters in place; returns the gradients' global
        norm.  The step count moves even when the update is skipped."""
        g_norm = self.tx.apply(self.params, grads, self.opt_state)
        self.step += 1
        return g_norm


def create_train_state(model: A3TMLMModel, tx: Optimizer,
                       device=None) -> TrainState:
    """Move ``model`` (with its initial weights) to ``device`` (cuda unless
    the caller asks for the CPU) and start the optimizer's state there."""
    model.to(resolve_device(device))
    return TrainState(step=0, model=model,
                      opt_state=tx.init(model.parameters()), tx=tx)


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


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def _check_device(frontend: LogMelFrontend, device) -> None:
    dev = resolve_device(device)
    if frontend.device != dev:
        raise ValueError(f"the front-end runs on {frontend.device}, the "
                         f"step on {dev}")


def make_train_step(model: A3TMLMModel, frontend: LogMelFrontend,
                    device=None, normalizer=None, use_fused: bool = True,
                    corpus=None):
    """Build the train step ``(state, batch, rng) -> (state, stats)`` on
    ``device`` (cuda unless the caller asks for the CPU).  ``normalizer``,
    ``use_fused`` and ``corpus`` go to :func:`featurize` (the matmul-DFT
    front-end by default, as in JAX).

    ``stats`` holds device tensors: ``loss``, ``loss_mlm``,
    ``masked_frames``, ``grad_norm`` (before clipping) and
    ``notfinite_count``.  BatchNorm running statistics move in the forward,
    as the JAX step's ``batch_stats`` do, also on a skipped step.
    """
    _check_device(frontend, device)
    use_mse = model.config.use_mse_loss

    def step(state: TrainState, batch: dict, rng):
        m = state.model
        m.train()
        mb = featurize(frontend, batch, use_fused=use_fused,
                       normalizer=normalizer, corpus=corpus)
        check_bucket(m, mb["speech"].shape[1])
        before, after = m(**mb, generator=_generator(rng))
        loss = mlm_loss(before, after, mb["speech"], mb["masked_position"],
                        use_mse=use_mse)
        params = state.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        grad_norm = state.apply_gradients(grads)
        loss = loss.detach()
        return state, {"loss_mlm": loss, "loss": loss,
                       "masked_frames": mb["masked_position"].sum(),
                       "grad_norm": grad_norm,
                       "notfinite_count": state.opt_state.notfinite_count}

    return step


def make_eval_step(model: A3TMLMModel, frontend: LogMelFrontend,
                   device=None, normalizer=None):
    """Validation step ``(state, batch) -> stats``: no gradients, running
    BatchNorm statistics, no dropout; the matmul-DFT front-end, as in
    JAX."""
    _check_device(frontend, device)
    use_mse = model.config.use_mse_loss

    def step(state: TrainState, batch: dict):
        m = state.model
        m.eval()
        with torch.no_grad():
            mb = featurize(frontend, batch, normalizer=normalizer)
            before, after = m(**mb)
            loss = mlm_loss(before, after, mb["speech"],
                            mb["masked_position"], use_mse=use_mse)
        return {"loss": loss, "loss_mlm": loss}

    return step
