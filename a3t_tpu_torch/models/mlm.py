"""The A3T masked-reconstruction model (``a3t_tpu/models/mlm.py``).

A dual-embed Conformer encoder consumes [masked mel frames ; phone tokens]
with a shared segment embedding aligning the two modalities; a second
Conformer stack ("decoder") refines the concatenated states; the speech slice
goes through the linear ``sfc`` head and a Tacotron2 postnet.  The longformer
configuration has no decoder, absolute positional encodings and a speech-only
pre-encoder (``pre_speech_encoders``) before the concat, and may compute in
bfloat16 with the JAX model's casts (:207-218, :312, the postnet at :181).
Parameter names are ESPnet's ``ESPnetMLMEncAsDecoderModel`` names, which
``a3t_tpu/compat/torch_import.py::convert_model_state`` maps onto the flax
tree; that map has no name for the pre-encoder, which takes the JAX tree's
name.  ``model.train()`` turns on dropout (seeds from the ``generator``
given to ``forward``) and batch-statistics BatchNorm; :func:`mlm_loss` is the
masked L1 training loss.

With ``spemb_dim > 0`` the model conditions on an utterance-level speaker
embedding (an x-vector, ``models/xvector.py``) at three sites, as the JAX
model does (:141-159, :230-234, :297-316): L2-normalised (epsilon 1e-8; a
missing embedding is zeros), projected by ``spemb_proj`` onto both
modalities' embeddings, by ``spemb_proj_mid`` onto the encoder's output and
by the zero-initialised ``spemb_out`` onto the output mel.  ESPnet has no
names for them, so they keep the JAX tree's names.  The duration-aware
variant (``duration_predictor_layers > 0``) adds a duration predictor on
the encoder's speech states and :meth:`A3TMLMModel.tts_forward`.

``A3TMLMModel(config, shard)`` is the model's slice on rank t of the mesh's
model axis (``parallel/``): every Conformer block holds its rank's heads
and hidden units and everything else is whole.  :func:`build_model` builds
the slice of the live mesh's rank from the seeded initialisation of the
whole model, so the weights at tp = 2 are the slices of tp = 1's.

On a rank of the mesh's seq axis, ``forward(..., seq=layout)`` and
``tts_forward`` take the rank's frame block of every (B, F, ...) input and
the whole text (``parallel/sequence.py``); they return the outputs of the
block's frames, and the ranks together compute what one process computes
on the whole frames (``train/train_step.py`` slices the inputs).

``forward(..., speech_only=True)`` is the branch of speech-only corpora
(the JAX model's :222-224, the reference's conformer/encoder.py:531-537):
the sentinel text token gets ``segment_emb(0)``, the speech no segment
embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.models.conformer import (
    AbsPosEncoding,
    ConformerStack,
    EncoderConfig,
    RelPosEncoding,
)
from a3t_tpu_torch.models.layers import (DurationPredictor, MaskedInput,
                                         Postnet, dense, length_regulate)
from a3t_tpu_torch.parallel.mesh import all_reduce_sum, model_rank, model_world
from a3t_tpu_torch.parallel.sequence import frame_block, gather_frames
from a3t_tpu_torch.parallel.sharding import shard_state
from a3t_tpu_torch.parallel.tensor import ModelShard


@dataclasses.dataclass(frozen=True)
class A3TModelConfig:
    """Model hyperparameters (conf/fsp2_conformer.yaml:26-75 defaults)."""

    odim: int = 80
    vocab_size: int = 100
    encoder: EncoderConfig = EncoderConfig(cnn_module_kernel=7)
    decoder: Optional[EncoderConfig] = EncoderConfig(cnn_module_kernel=31)
    use_segment_emb: bool = True
    segment_vocab: int = 500
    postnet_layers: int = 5
    postnet_chans: int = 256
    postnet_filts: int = 5
    duration_predictor_layers: int = 0
    spemb_dim: int = 0
    # loss settings (sedit_model.py:105-108)
    use_mse_loss: bool = False
    mlm_prob: float = 0.8
    mean_phn_span: int = 8


class MLMEncoder(ConformerStack):
    """The encoder stack with the modality embeddings it owns in ESPnet's
    MLMEncoder: speech_embed = [MaskedInput, Linear, LayerNorm] (+ ReLU),
    text_embed = [Embedding], segment_emb."""

    def __init__(self, c: A3TModelConfig, shard: ModelShard = ModelShard()):
        super().__init__(c.encoder, shard=shard)
        d = c.encoder.attention_dim
        self.speech_embed = nn.ModuleList([
            MaskedInput(c.odim), nn.Linear(c.odim, d), nn.LayerNorm(d, eps=1e-5)])
        self.text_embed = nn.ModuleList([nn.Embedding(c.vocab_size, d)])
        if c.use_segment_emb:
            self.segment_emb = nn.Embedding(c.segment_vocab, d)


class A3TMLMModel(nn.Module):
    """Encoder-as-decoder A3T model.

    forward inputs, padded to static shapes:
        speech (B, F, odim) mel; text (B, T) phone ids;
        masked_position, speech_mask (B, F) bool; text_mask (B, T) bool;
        speech_segment_pos (B, F), text_segment_pos (B, T) int.
    Returns ``(before_outs, after_outs)``, each (B, F, odim) float32
    (``after_outs`` is None without a postnet), and with
    ``return_log_durations=True`` the duration predictor's (B, F) output
    as a third element (None without a predictor).  In training mode
    ``generator`` (a CPU ``torch.Generator``) seeds every dropout site, the
    JAX model's ``rngs={"dropout": ...}``.  ``shard``: the model's place on
    the mesh's model axis (module docstring).
    """

    def __init__(self, config: A3TModelConfig,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        c = config
        self.config = c
        self.shard = shard
        d = c.encoder.attention_dim
        self.encoder = MLMEncoder(c, shard)
        if c.spemb_dim > 0:
            self.spemb_proj = nn.Linear(c.spemb_dim, d)
            self.spemb_proj_mid = nn.Linear(c.spemb_dim, d)
            self.spemb_out = nn.Linear(c.spemb_dim, c.odim)
        self.posenc = _posenc(c.encoder)
        self.pre_speech_encoders = None
        if c.encoder.pre_speech_layers > 0:
            self.pre_speech_encoders = ConformerStack(
                dataclasses.replace(c.encoder,
                                    num_blocks=c.encoder.pre_speech_layers),
                apply_final_norm=False, shard=shard)
        if c.decoder is not None:
            self.decoder_posenc = _posenc(c.decoder)
            self.decoder = ConformerStack(c.decoder, shard=shard)
        self.sfc = nn.Linear(d, c.odim)
        if c.postnet_layers > 0:
            self.postnet = Postnet(c.odim, c.postnet_layers, c.postnet_chans,
                                   c.postnet_filts, dtype=c.encoder.dtype)
        if c.duration_predictor_layers > 0:
            # the JAX variant's fixed n_chans 256, kernel 3, dropout 0.1
            self.duration_predictor = DurationPredictor(
                d, n_layers=c.duration_predictor_layers)

    def _norm_spemb(self, spemb, batch_size: int, device) -> torch.Tensor:
        """The L2-normalised speaker embedding (epsilon 1e-8), zeros when
        absent (the projections' biases alone)."""
        if spemb is None:
            spemb = torch.zeros(batch_size, self.config.spemb_dim,
                                device=device)
        spemb = spemb.float()
        return spemb / (torch.linalg.vector_norm(spemb, dim=-1, keepdim=True)
                        + 1e-8)

    def encode(self, speech, text, masked_position, speech_mask, text_mask,
               speech_segment_pos, text_segment_pos, spemb=None,
               generator=None, speech_only: bool = False, seq=None):
        """((B, F + T, d) encoder states, (B, 1, F + T) mask).  With a
        ``seq`` layout the inputs and the states are the rank's frame block
        and the text, (B, F / sp + T, d), and the mask is the whole
        sequence's key mask."""
        enc = self.encoder
        sp_seq = None if seq is None else seq.speech()
        dt = self.config.encoder.dtype
        n_frames = speech.shape[1]
        if dt is not None:
            speech = speech.to(dt)
        masked_input, proj, norm = enc.speech_embed
        # speech_proj, LayerNorm and Embed have no compute dtype: flax
        # promotes their bfloat16 inputs to float32
        h_speech = F.relu(norm(dense(proj, masked_input(speech,
                                                        masked_position))))
        h_text = enc.text_embed[0](text)
        if dt is not None:
            h_speech, h_text = h_speech.to(dt), h_text.to(dt)
        h_speech, pos_speech = self.posenc(h_speech, generator, sp_seq)
        h_text, pos_text = self.posenc(h_text, generator)
        if self.config.use_segment_emb:
            if speech_only:
                h_text = h_text + enc.segment_emb(torch.zeros_like(text))
            else:
                h_speech = h_speech + enc.segment_emb(speech_segment_pos)
                h_text = h_text + enc.segment_emb(text_segment_pos)
        if self.config.spemb_dim > 0:
            se = self._norm_spemb(spemb, speech.shape[0], speech.device)
            # no compute dtype: flax promotes to float32
            se = dense(self.spemb_proj, se.to(h_speech.dtype))[:, None, :]
            h_speech, h_text = h_speech + se, h_text + se
        speech_mask = gather_frames(speech_mask, sp_seq)
        if self.pre_speech_encoders is not None:
            h_speech = self.pre_speech_encoders(
                h_speech, pos_speech, speech_mask[:, None, :], generator,
                n_frames, sp_seq)
        x = torch.cat([h_speech, h_text], dim=1)
        pos_emb = None if pos_speech is None else \
            torch.cat([pos_speech, pos_text], dim=1)
        mask = torch.cat([speech_mask, text_mask], dim=1)[:, None, :]
        joint = None if seq is None else seq.with_tail(text.shape[1])
        return enc(x, pos_emb, mask, generator, n_frames, joint), mask

    def decode(self, x, mask, generator=None, n_frames=None, seq=None):
        """The refinement stack re-scales and takes a fresh positional table
        over the full concatenated length (conformer/encoder.py:568-614);
        ``seq``: ``x``'s rows on the seq axis, frames then text."""
        x, pos_full = self.decoder_posenc(x, generator, seq)
        return self.decoder(x, pos_full, mask, generator, n_frames, seq)

    def _mid(self, hidden, spemb):
        """The encoder output plus ``spemb_proj_mid``'s projection of the
        speaker embedding; (hidden, normalised embedding or None)."""
        if self.config.spemb_dim <= 0:
            return hidden, None
        se = self._norm_spemb(spemb, hidden.shape[0], hidden.device)
        return hidden + dense(self.spemb_proj_mid, se.to(hidden.dtype)
                              )[:, None, :], se

    def _predict(self, speech_hidden, speech_mask, generator, seq=None):
        """Log durations (B, F), 0 at padded frames; the predictor has no
        compute dtype, so flax promotes a bfloat16 input to float32."""
        return self.duration_predictor(speech_hidden.float(), ~speech_mask,
                                       generator, seq)

    def _head(self, speech_hidden, se, generator, seq=None):
        """``sfc``, the speaker offset and the postnet: (before, after)."""
        before_outs = self.sfc(speech_hidden).float()
        if se is not None:
            before_outs = before_outs + self.spemb_out(se).float()[:, None, :]
        after_outs = None
        if self.config.postnet_layers > 0:
            after_outs = before_outs + self.postnet(before_outs, generator,
                                                    seq)
        return before_outs, after_outs

    def forward(self, speech, text, masked_position, speech_mask, text_mask,
                speech_segment_pos, text_segment_pos, spemb=None,
                generator=None, return_log_durations: bool = False,
                speech_only: bool = False, seq=None):
        """``spemb`` (B, spemb_dim): the speaker embedding of a
        speaker-conditioned model (zeros when None); a model without
        speaker conditioning ignores it, as the JAX model does.  The
        duration predictor reads the encoder output's speech slice, before
        the decoder (sedit_model.py:420-428).  ``speech_only``: the
        segment embeddings of speech-only batches (module docstring).
        ``seq``: the rank's layout on the seq axis (``parallel/
        sequence.py``); the frame inputs are then its block."""
        n_frames = speech.shape[1]
        sp_seq = None if seq is None else seq.speech()
        hidden, mask = self.encode(
            speech, text, masked_position, speech_mask, text_mask,
            speech_segment_pos, text_segment_pos, spemb, generator,
            speech_only, seq)
        hidden, se = self._mid(hidden, spemb)
        log_d = None
        if self.config.duration_predictor_layers > 0:
            log_d = self._predict(hidden[:, :n_frames], speech_mask,
                                  generator, sp_seq)
        if self.config.decoder is not None:
            hidden = self.decode(hidden, mask, generator, n_frames,
                                 None if seq is None
                                 else seq.with_tail(text.shape[1]))
        outs = self._head(hidden[:, :n_frames], se, generator, sp_seq)
        return (*outs, log_d) if return_log_durations else outs

    def tts_forward(self, speech, text, masked_position, speech_mask,
                    text_mask, speech_segment_pos, text_segment_pos,
                    durations, out_frames: int, spemb=None, generator=None,
                    seq=None):
        """The duration-aware variant's forward (ESPnetMLMTTSModel._forward,
        sedit_model.py:415-452; JAX ``tts_forward``).

        ``speech``, ``masked_position``, ``speech_mask`` and
        ``speech_segment_pos`` are the duration-reduced sequence (B, R, ...)
        (a masked phone collapsed to its first frame); ``durations`` (B, R)
        the frames of each reduced position.  The encoder runs over the
        reduced sequence; its speech states, length-regulated by
        ``durations * speech_mask`` to ``out_frames`` frames, are followed by
        its text states, and the decoder runs over both with the mask
        [frame valid, text mask].  Returns (before_outs, after_outs) at
        ``out_frames`` frames and the (B, R) log durations.

        With a ``seq`` layout (of the R reduced positions) the reduced
        inputs are the rank's block; a frame's phone depends on the
        cumulative durations of the whole row, so the block's speech
        states are all-gathered over the seq group, regulated whole, and
        the rank keeps its block of the ``out_frames`` frames (the outputs
        are that block's)."""
        n_red = speech.shape[1]
        hidden, _ = self.encode(
            speech, text, masked_position, speech_mask, text_mask,
            speech_segment_pos, text_segment_pos, spemb, generator,
            seq=seq)
        hidden, se = self._mid(hidden, spemb)
        red_seq = None if seq is None else seq.speech()
        log_d = self._predict(hidden[:, :n_red], speech_mask, generator,
                              red_seq)
        expanded, frame_valid = length_regulate(
            gather_frames(hidden[:, :n_red], red_seq),
            gather_frames(durations * speech_mask, red_seq), out_frames)
        out_seq = None if seq is None else dataclasses.replace(
            seq, frames=out_frames, tail=text.shape[1])
        expanded = frame_block(expanded, out_seq)
        n_out = expanded.shape[1]
        hidden = torch.cat([expanded, hidden[:, n_red:]], dim=1)
        mask = torch.cat([frame_valid, text_mask], dim=1)[:, None, :]
        if self.config.decoder is not None:
            hidden = self.decode(hidden, mask, generator, n_out, out_seq)
        before_outs, after_outs = self._head(
            hidden[:, :n_out], se, generator,
            None if out_seq is None else out_seq.speech())
        return before_outs, after_outs, log_d


def _posenc(c: EncoderConfig) -> nn.Module:
    """Relative positions for legacy rel-pos stacks, absolute otherwise
    (the JAX model's ``_PosEnc`` kinds)."""
    kind = c.selfattention_layer_type
    if kind in ("legacy_rel_selfattn", "rel_selfattn"):
        return RelPosEncoding(c.attention_dim, c.positional_dropout_rate,
                              legacy=kind == "legacy_rel_selfattn")
    return AbsPosEncoding(c.attention_dim, c.positional_dropout_rate)


def mlm_loss(before_outs, after_outs, target, masked_position,
             use_mse: bool = False):
    """Masked reconstruction loss (sedit_model.py:320-340): per-frame L1
    (or MSE) summed over the mel bins, before plus after the postnet,
    averaged over the masked frames.  The denominator is the masked count
    of the global batch, summed over the data and seq axes' ranks
    (``parallel/mesh.py``; this rank's own count in one process): the
    ranks' losses then sum to the global batch's, as GSPMD's mean over the
    data and seq axes gives in JAX.  The model axis's ranks hold the same
    rows and the same loss."""
    def err(out):
        d = out - target
        return (d * d if use_mse else d.abs()).sum(dim=-1)

    loss = err(before_outs)
    if after_outs is not None:
        loss = loss + err(after_outs)
    w = masked_position.to(loss.dtype)
    return (loss * w).sum() / (all_reduce_sum(w.sum(), "data_seq") + 1e-10)


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's initialisers: xavier
    uniform for dense, conv, recurrent and positional-bias weights, zero
    biases, standard normal embeddings, mask feature and style tokens,
    identity BatchNorm, a scaled positional encoding's ``alpha`` one, and
    the speaker offset ``spemb_out`` zero (mlm.py:154-159)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            if leaf.startswith("bias") or owner == "spemb_out":
                p.zero_()
            elif p.dim() == 0 or (p.dim() == 1 and leaf == "weight"):
                # LayerNorm / BatchNorm scale and alpha are one
                p.fill_(1.0)
            elif leaf in ("mask_feature", "gst_embs") or isinstance(
                    model.get_submodule(owner), nn.Embedding):
                p.normal_(generator=generator)
            else:
                nn.init.xavier_uniform_(p, generator=generator)
    return model


def build_model(config: A3TModelConfig, device=None, seed: int = 0,
                shard: Optional[ModelShard] = None) -> A3TMLMModel:
    """An A3TMLMModel with seeded random weights, in eval mode on ``device``
    (cuda unless the caller asks for the CPU).  ``shard`` None is this
    rank's place on the live mesh's model axis (the whole model without
    one): the slice of the whole model's seeded weights."""
    dev = resolve_device(device)
    model = A3TMLMModel(config)
    init_parameters(model, torch.Generator().manual_seed(seed))
    if shard is None:
        shard = ModelShard(model_rank(), model_world())
    if shard.size > 1:
        full = model.state_dict()
        model = A3TMLMModel(config, shard)
        model.load_state_dict(shard_state(full, shard.rank, shard.size))
    return model.to(dev).eval()
