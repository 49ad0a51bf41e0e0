"""FastSpeech2 (``a3t_tpu/models/fastspeech2.py``; reference
espnet2/tts/fastspeech2/fastspeech2.py:40-842): non-autoregressive TTS with
variance adaptors, in two roles of the A3T inference stack:

* duration prediction for new phones (encoder -> GST style embedding ->
  x-vector integration -> duration predictor, sedit_inference.py:398-424),
* the baseline TTS systems of ``inference/baselines.py``.

The length regulator keeps JAX's static semantics: the output has
``max_feat_len`` frames, frames past the total duration are zero and
masked, and a total past ``max_feat_len`` is cut.  The decoder runs over
all ``max_feat_len`` frames, as in JAX: the conformer's conv module reads
the padded frames unmasked, so trimming them would change the last real
frames.

The conformer form (``encoder_conformer=True``, the published GST +
x-vector FastSpeech2) runs legacy rel-pos attention, so on the card every
block's attention goes through the fused kernels (K1 forward, K2 backward);
the transformer form runs plain self-attention with scaled absolute
positions.  Parameter names are ESPnet's (``encoder.embed.0`` the token
embedding, ``encoder.embed.1.alpha`` / ``decoder.embed.0.alpha`` the scaled
positional encodings, ``duration_predictor``, ``pitch_embed.0``, ...), which
``a3t_tpu/compat/fs2_import.py::convert_fs2_state`` maps onto the flax tree;
the transformer blocks keep the conformer block's ``norm_mha``/``norm_ff``
(ESPnet's ``norm1``/``norm2``, renamed by ``compat/fs2.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.models.conformer import (
    AbsPosEncoding,
    ConformerStack,
    EncoderConfig,
    RelPosEncoding,
)
from a3t_tpu_torch.models.gst import StyleEncoder
from a3t_tpu_torch.models.layers import (
    DurationPredictor,
    Postnet,
    VariancePredictor,
    duration_loss,
    length_regulate,
)
from a3t_tpu_torch.models.mlm import init_parameters


def transformer_stack_config(
    adim=384, aheads=4, layers=6, units=1536, dropout=0.1,
    positionwise_layer_type="conv1d", positionwise_conv_kernel_size=1,
) -> EncoderConfig:
    """A plain transformer as a ConformerStack config: no macaron halves, no
    conv module, absolute-position self-attention."""
    return EncoderConfig(
        attention_dim=adim, attention_heads=aheads, linear_units=units,
        num_blocks=layers, dropout_rate=dropout,
        positional_dropout_rate=dropout, attention_dropout_rate=dropout,
        macaron_style=False, use_cnn_module=False,
        positionwise_layer_type=positionwise_layer_type,
        positionwise_conv_kernel_size=positionwise_conv_kernel_size,
        selfattention_layer_type="selfattn",
    )


@dataclasses.dataclass(frozen=True)
class FastSpeech2Config:
    """The JAX package's ``FastSpeech2Config`` field for field."""

    idim: int = 100  # vocabulary (eos = idim - 1, pad = 0)
    odim: int = 80
    adim: int = 384
    encoder: EncoderConfig = transformer_stack_config()
    decoder: EncoderConfig = transformer_stack_config()
    encoder_conformer: bool = False  # True: conformer stacks (rel-pos)
    use_scaled_pos_enc: bool = True
    postnet_layers: int = 5
    postnet_chans: int = 512
    postnet_filts: int = 5
    duration_predictor_layers: int = 2
    duration_predictor_chans: int = 384
    duration_predictor_kernel: int = 3
    variance_predictor_layers: int = 2
    variance_predictor_chans: int = 384
    variance_predictor_kernel: int = 3
    variance_embed_kernel: int = 9
    variance_dropout: float = 0.5
    # per-predictor overrides (None: the variance_* values)
    pitch_predictor_layers: Optional[int] = None
    pitch_predictor_chans: Optional[int] = None
    pitch_predictor_kernel: Optional[int] = None
    pitch_embed_kernel: Optional[int] = None
    energy_predictor_layers: Optional[int] = None
    energy_predictor_chans: Optional[int] = None
    energy_predictor_kernel: Optional[int] = None
    energy_embed_kernel: Optional[int] = None
    use_gst: bool = False
    gst_tokens: int = 10
    gst_heads: int = 4
    gst_conv_chans_list: tuple = (32, 32, 64, 64, 128, 128)
    gst_gru_units: int = 128
    spk_embed_dim: Optional[int] = None
    spk_embed_integration_type: str = "add"  # "add" | "concat"
    max_feat_len: int = 2048  # the length regulator's static length


def _or(v, default):
    return default if v is None else v


class _Stack(ConformerStack):
    """An encoder or decoder stack with ESPnet's ``embed`` in front: the
    token embedding (encoder only) and the positional encoding."""

    def __init__(self, stack: EncoderConfig, posenc: nn.Module,
                 vocab: Optional[int] = None):
        super().__init__(stack)
        self.embed = nn.ModuleList(
            ([nn.Embedding(vocab, stack.attention_dim)] if vocab else [])
            + [posenc])

    def forward(self, x, mask, generator=None):
        for layer in self.embed[:-1]:
            x = layer(x)
        h, pos = self.embed[-1](x, generator)
        return super().forward(h, pos, mask, generator)


class FastSpeech2(nn.Module):
    """FastSpeech2 with the JAX module's entry points: :meth:`encode_hidden`
    (the duration-prediction path), :meth:`predict_durations` and
    :meth:`forward` (full synthesis, teacher-forced when durations, pitch
    and energy are given).  ``model.train()`` turns on dropout (seeds from
    the ``generator`` given to each call) and batch-statistics BatchNorm."""

    def __init__(self, config: FastSpeech2Config):
        super().__init__()
        c = self.config = config
        if c.spk_embed_integration_type not in ("add", "concat"):
            raise ValueError(f"spk_embed_integration_type "
                             f"{c.spk_embed_integration_type!r}")
        kind = c.encoder.selfattention_layer_type

        def posenc(stack):
            if c.encoder_conformer:
                return RelPosEncoding(
                    c.adim, stack.positional_dropout_rate,
                    legacy=kind == "legacy_rel_selfattn")
            return AbsPosEncoding(c.adim, stack.positional_dropout_rate,
                                  scaled=c.use_scaled_pos_enc)

        self.encoder = _Stack(c.encoder, posenc(c.encoder), vocab=c.idim)
        self.decoder = _Stack(c.decoder, posenc(c.decoder))
        if c.use_gst:
            self.gst = StyleEncoder(
                idim=c.odim, gst_tokens=c.gst_tokens, gst_token_dim=c.adim,
                gst_heads=c.gst_heads, conv_chans_list=c.gst_conv_chans_list,
                gru_units=c.gst_gru_units)
        if c.spk_embed_dim is not None:
            concat = c.spk_embed_integration_type == "concat"
            self.projection = nn.Linear(
                c.spk_embed_dim + (c.adim if concat else 0), c.adim)
        self.duration_predictor = DurationPredictor(
            c.adim, c.duration_predictor_layers, c.duration_predictor_chans,
            c.duration_predictor_kernel)
        self.pitch_predictor = VariancePredictor(
            c.adim, _or(c.pitch_predictor_layers, c.variance_predictor_layers),
            _or(c.pitch_predictor_chans, c.variance_predictor_chans),
            _or(c.pitch_predictor_kernel, c.variance_predictor_kernel),
            c.variance_dropout)
        self.energy_predictor = VariancePredictor(
            c.adim,
            _or(c.energy_predictor_layers, c.variance_predictor_layers),
            _or(c.energy_predictor_chans, c.variance_predictor_chans),
            _or(c.energy_predictor_kernel, c.variance_predictor_kernel),
            c.variance_dropout)
        # ESPnet's Sequential(Conv1d, Dropout) with a dropout rate of 0
        self.pitch_embed = nn.ModuleList([nn.Conv1d(
            1, c.adim, _or(c.pitch_embed_kernel, c.variance_embed_kernel),
            padding="same")])
        self.energy_embed = nn.ModuleList([nn.Conv1d(
            1, c.adim, _or(c.energy_embed_kernel, c.variance_embed_kernel),
            padding="same")])
        self.feat_out = nn.Linear(c.adim, c.odim)
        if c.postnet_layers > 0:
            self.postnet = Postnet(c.odim, c.postnet_layers, c.postnet_chans,
                                   c.postnet_filts)

    # -- encoder side ----------------------------------------------------
    def encode_hidden(self, text, text_mask, speech=None, spembs=None,
                      generator=None):
        """Token ids (B, T) -> hidden states (B, T, adim) after the style
        and x-vector integration.  The "add" integration normalises the
        x-vector with no epsilon (fastspeech2.py:235-243)."""
        c = self.config
        hs = self.encoder(text, text_mask[:, None, :], generator)
        if c.use_gst and speech is not None:
            hs = hs + self.gst(speech)[:, None, :]
        if c.spk_embed_dim is not None and spembs is not None:
            norm = spembs / torch.linalg.vector_norm(spembs, dim=-1,
                                                     keepdim=True)
            if c.spk_embed_integration_type == "add":
                hs = hs + self.projection(norm)[:, None, :]
            else:
                hs = self.projection(torch.cat(
                    [hs, norm[:, None, :].expand(-1, hs.shape[1], -1)], -1))
        return hs

    def predict_durations(self, text, text_mask, speech=None, spembs=None):
        """Integer frame durations per token (B, T), zero on padding."""
        hs = self.encode_hidden(text, text_mask, speech, spembs)
        log_d = self.duration_predictor(hs, pad_mask=~text_mask)
        return DurationPredictor.to_durations(log_d) * text_mask

    # -- full synthesis --------------------------------------------------
    def forward(self, text, text_mask, speech=None, spembs=None,
                durations=None, pitch=None, energy=None, alpha: float = 1.0,
                generator=None) -> dict:
        """A dict of ``before``/``after`` mels (B, max_feat_len, odim), the
        predicted ``log_duration`` (B, T), ``pitch`` and ``energy`` (B, T,
        1), ``frame_valid`` (B, max_feat_len) and the ``durations`` used.
        Given ``durations``/``pitch``/``energy`` (teacher forcing) are used,
        else the predictions."""
        c = self.config
        hs = self.encode_hidden(text, text_mask, speech, spembs, generator)
        pad = ~text_mask
        log_d = self.duration_predictor(hs, pad, generator)
        p_out = self.pitch_predictor(hs, pad, generator)
        e_out = self.energy_predictor(hs, pad, generator)

        use_pitch = p_out if pitch is None else pitch
        use_energy = e_out if energy is None else energy
        hs = (hs + self.pitch_embed[0](use_pitch.transpose(1, 2)).transpose(
            1, 2) + self.energy_embed[0](use_energy.transpose(1, 2)
                                         ).transpose(1, 2))
        if durations is None:
            d = DurationPredictor.to_durations(log_d) * text_mask
            if alpha != 1.0:
                d = torch.round(d.float() * alpha).to(torch.int64)
        else:
            d = durations
        hs_up, frame_valid = length_regulate(hs, d, c.max_feat_len)
        zs = self.decoder(hs_up, frame_valid[:, None, :], generator)
        before = self.feat_out(zs)
        after = before
        if c.postnet_layers > 0:
            after = before + self.postnet(before, generator)
        return dict(before=before, after=after, log_duration=log_d,
                    pitch=p_out, energy=e_out, frame_valid=frame_valid,
                    durations=d)


def fastspeech2_loss(out: dict, targets: dict, text_mask) -> dict:
    """L1 mel (before and after the postnet) over the valid frames plus the
    MSE of log-duration, pitch and energy over the tokens
    (fastspeech2.py:304-327)."""
    frame_w = out["frame_valid"].float()[..., None]
    mel_t = targets["mel"]
    l1 = (out["before"] - mel_t).abs() + (out["after"] - mel_t).abs()
    l1 = (l1 * frame_w).sum() / (frame_w.sum() * mel_t.shape[-1] + 1e-10)
    tw = text_mask.float()
    d_l = duration_loss(out["log_duration"], targets["durations"])
    d_l = (d_l * tw).sum() / (tw.sum() + 1e-10)
    p_l = ((out["pitch"] - targets["pitch"]) ** 2 * tw[..., None]).sum() / (
        tw.sum() + 1e-10)
    e_l = ((out["energy"] - targets["energy"]) ** 2 * tw[..., None]).sum() / (
        tw.sum() + 1e-10)
    return dict(loss=l1 + d_l + p_l + e_l, l1_loss=l1, duration_loss=d_l,
                pitch_loss=p_l, energy_loss=e_l)


def build_fs2(config: FastSpeech2Config, device=None,
              seed: int = 0) -> FastSpeech2:
    """A FastSpeech2 with seeded random weights (the JAX package's
    initialisers, ``models/mlm.py::init_parameters``), in eval mode on
    ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    model = FastSpeech2(config)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
