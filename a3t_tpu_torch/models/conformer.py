"""Conformer encoder/decoder stacks (``a3t_tpu/models/conformer.py``).

Two block types are ported: the 24 kHz A3T block (macaron feed-forward
halves, legacy rel-pos self-attention, conv module with BatchNorm) and the
16 kHz longformer block (sliding-window attention with global text tokens,
no conv module), both pre-LayerNorm, each in float32 or bfloat16 compute.
Module names follow ESPnet's EncoderLayer (conformer/encoder_layer.py) so
state dicts map onto the JAX package's tree.

Mixed precision follows flax's promotion: LayerNorms keep the float32
stream, the attention projections, feed-forwards and conv module run in the
compute dtype (BatchNorm in a float32 round trip), and each residual sum
promotes back to float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from a3t_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from a3t_tpu_torch.models.dropout import SeededDropout
from a3t_tpu_torch.models.layers import (
    ConvolutionModule,
    MultiLayeredConv1d,
    PositionwiseFeedForward,
    sinusoidal_table,
)
from a3t_tpu_torch.models.windowed_attention import WindowedSelfAttention


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Conformer stack hyperparameters; the field names and defaults are the
    JAX package's (egs2/vctk/sedit/conf/fsp2_conformer.yaml:26-64)."""

    attention_dim: int = 384
    attention_heads: int = 2
    linear_units: int = 1536
    num_blocks: int = 4
    dropout_rate: float = 0.2
    positional_dropout_rate: float = 0.2
    attention_dropout_rate: float = 0.2
    normalize_before: bool = True
    macaron_style: bool = True
    use_cnn_module: bool = True
    cnn_module_kernel: int = 7
    positionwise_layer_type: str = "conv1d"  # "conv1d" | "linear"
    positionwise_conv_kernel_size: int = 3
    activation_type: str = "swish"
    # "legacy_rel_selfattn" | "longformer" (sliding window + global text)
    selfattention_layer_type: str = "legacy_rel_selfattn"
    attention_window: int = 0  # full window of "longformer"
    attention_dilation: int = 1
    # the longformer band through the banded kernels (K3-K5)
    use_pallas_attention: bool = True
    # route the softmax and P.V through the fused CUDA kernel
    use_flash_attention: bool = True
    # speech-only pre-encoder blocks before the text concat (A3TMLMModel)
    pre_speech_layers: int = 0
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    @property
    def dtype(self):
        """The compute dtype, None for float32 (flax's convention)."""
        return None if self.compute_dtype == "float32" else torch.bfloat16

    def check_supported(self) -> None:
        kind = self.selfattention_layer_type
        if kind not in ("legacy_rel_selfattn", "longformer"):
            raise NotImplementedError(f"{kind!r} attention is not ported")
        if kind == "longformer" and self.attention_dilation != 1:
            raise NotImplementedError("attention dilation is not ported")
        if kind == "longformer" and not self.use_pallas_attention:
            raise NotImplementedError(
                "the chunked-einsum longformer path is not ported")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r} is not ported")
        if not self.normalize_before:
            raise NotImplementedError("post-LayerNorm stacks are not ported")


class RelPosEncoding(nn.Module):
    """x -> (dropout(x * sqrt(d)), dropout(pos_emb)), two separate draws,
    with LegacyRelPositionalEncoding's quirk: the reversed table is built
    over ``max(T, max_len)`` positions and the first T rows are taken, so
    row i carries position ``max(T, max_len) - 1 - i``.  Trained checkpoints
    depend on this table.

    As in flax, ``x * np.float32(sqrt(d))`` promotes a bfloat16 ``x`` to
    float32, while the table takes ``x``'s dtype (conformer.py:130-131).
    """

    def __init__(self, d_model: int, dropout_rate: float = 0.0,
                 max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.dropout = SeededDropout(dropout_rate)

    def forward(self, x, generator=None):
        t = x.shape[1]
        pe = sinusoidal_table(max(t, self.max_len), self.d_model,
                              reverse=True)[:t]
        pos_emb = torch.tensor(pe, dtype=x.dtype, device=x.device)[None]
        y = x.to(torch.promote_types(x.dtype, torch.float32)) \
            * float(np.float32(math.sqrt(self.d_model)))
        return (self.dropout(y, generator), self.dropout(pos_emb, generator))


class AbsPosEncoding(nn.Module):
    """x -> (dropout(x * sqrt(d) + pe), None) (embedding.py:35-94,
    ``scaled=False``); the None stands for the relative table that
    :class:`RelPosEncoding` returns, as the JAX model's ``_PosEnc`` does.

    As in flax, ``x * np.float32(sqrt(d))`` promotes a bfloat16 ``x`` to
    float32, and the table is rounded to ``x``'s dtype before it is added.
    """

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = SeededDropout(dropout_rate)

    def forward(self, x, generator=None):
        pe = torch.tensor(sinusoidal_table(x.shape[1], self.d_model),
                          device=x.device)[None].to(x.dtype)
        y = x.float() * float(np.float32(math.sqrt(self.d_model))) + pe
        return self.dropout(y, generator), None


class ConformerBlock(nn.Module):
    """x += 1/2 drop(ff_macaron(LN(x))); x += drop(attn(LN(x)));
    x += drop(conv(LN(x))); x += 1/2 drop(ff(LN(x))); x = LN(x).

    The attention is legacy rel-pos MHA, or for ``longformer`` windowed
    attention over ``[speech (n_frames) ; text]`` with a flat key mask."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        c.check_supported()
        d = c.attention_dim

        def positionwise():
            if c.positionwise_layer_type == "conv1d":
                return MultiLayeredConv1d(d, c.linear_units,
                                          c.positionwise_conv_kernel_size,
                                          c.dropout_rate, dtype=c.dtype)
            if c.positionwise_layer_type == "linear":
                return PositionwiseFeedForward(d, c.linear_units,
                                               c.activation_type,
                                               c.dropout_rate, dtype=c.dtype)
            raise NotImplementedError(c.positionwise_layer_type)

        self.macaron = c.macaron_style
        self.ff_scale = 0.5 if c.macaron_style else 1.0
        if c.macaron_style:
            self.norm_ff_macaron = nn.LayerNorm(d, eps=1e-5)
            self.feed_forward_macaron = positionwise()
        self.norm_mha = nn.LayerNorm(d, eps=1e-5)
        self.longformer = c.selfattention_layer_type == "longformer"
        if self.longformer:
            self.self_attn = WindowedSelfAttention(
                d, c.attention_heads, c.attention_window,
                c.attention_dropout_rate, dtype=c.dtype)
        else:
            self.self_attn = RelPositionMultiHeadedAttention(
                d, c.attention_heads, use_flash=c.use_flash_attention,
                dropout_rate=c.attention_dropout_rate, dtype=c.dtype)
        self.use_cnn = c.use_cnn_module
        if c.use_cnn_module:
            self.norm_conv = nn.LayerNorm(d, eps=1e-5)
            self.conv_module = ConvolutionModule(d, c.cnn_module_kernel,
                                                 c.activation_type,
                                                 dtype=c.dtype)
            self.norm_final = nn.LayerNorm(d, eps=1e-5)
        self.norm_ff = nn.LayerNorm(d, eps=1e-5)
        self.feed_forward = positionwise()
        self.dropout = SeededDropout(c.dropout_rate)

    def forward(self, x, pos_emb, mask, generator=None, n_frames=None):
        def drop(h):
            return self.dropout(h, generator)

        if self.macaron:
            x = x + self.ff_scale * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator))
        h = self.norm_mha(x)
        if self.longformer:
            flat_mask = mask[:, 0] if mask is not None and mask.dim() == 3 \
                else mask
            h = self.self_attn(h, h.shape[1] if n_frames is None else n_frames,
                               flat_mask, generator)
        else:
            h = self.self_attn(h, pos_emb, mask, generator)
        x = x + drop(h)
        if self.use_cnn:
            x = x + drop(self.conv_module(self.norm_conv(x)))
        x = x + self.ff_scale * drop(self.feed_forward(self.norm_ff(x),
                                                       generator))
        if self.use_cnn:
            x = self.norm_final(x)
        return x


class ConformerStack(nn.Module):
    """num_blocks ConformerBlocks + the final LayerNorm, which the
    speech-only pre-encoder leaves out (``apply_final_norm=False``,
    transformer/encoder.py:547-548)."""

    def __init__(self, c: EncoderConfig, apply_final_norm: bool = True):
        super().__init__()
        self.encoders = nn.ModuleList(ConformerBlock(c)
                                      for _ in range(c.num_blocks))
        self.after_norm = (nn.LayerNorm(c.attention_dim, eps=1e-5)
                           if apply_final_norm else None)

    def forward(self, x, pos_emb, mask, generator=None, n_frames=None):
        for block in self.encoders:
            x = block(x, pos_emb, mask, generator, n_frames)
        return x if self.after_norm is None else self.after_norm(x)
