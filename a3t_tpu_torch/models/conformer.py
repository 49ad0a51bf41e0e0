"""Conformer encoder/decoder stacks (``a3t_tpu/models/conformer.py``).

The shipped A3T settings: macaron feed-forward halves, legacy rel-pos
self-attention, conv module with BatchNorm, pre-LayerNorm everywhere and a
final LayerNorm.  Module names follow ESPnet's EncoderLayer
(conformer/encoder_layer.py) so state dicts map onto the JAX package's tree.
"""

from __future__ import annotations

import dataclasses
import math

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
    selfattention_layer_type: str = "legacy_rel_selfattn"
    # route the softmax and P.V through the fused CUDA kernel
    use_flash_attention: bool = True
    pre_speech_layers: int = 0
    compute_dtype: str = "float32"

    def check_supported(self) -> None:
        if self.selfattention_layer_type != "legacy_rel_selfattn":
            raise NotImplementedError(
                f"{self.selfattention_layer_type!r} attention is not ported")
        if self.pre_speech_layers:
            raise NotImplementedError("pre_speech_layers are not ported")
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: the port runs float32")
        if not self.normalize_before:
            raise NotImplementedError("post-LayerNorm stacks are not ported")


class RelPosEncoding(nn.Module):
    """x -> (dropout(x * sqrt(d)), dropout(pos_emb)), two separate draws,
    with LegacyRelPositionalEncoding's quirk: the reversed table is built
    over ``max(T, max_len)`` positions and the first T rows are taken, so
    row i carries position ``max(T, max_len) - 1 - i``.  Trained checkpoints
    depend on this table.
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
        return (self.dropout(x * math.sqrt(self.d_model), generator),
                self.dropout(pos_emb, generator))


class ConformerBlock(nn.Module):
    """x += 1/2 drop(ff_macaron(LN(x))); x += drop(attn(LN(x)));
    x += drop(conv(LN(x))); x += 1/2 drop(ff(LN(x))); x = LN(x)."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        c.check_supported()
        d = c.attention_dim

        def positionwise():
            if c.positionwise_layer_type == "conv1d":
                return MultiLayeredConv1d(d, c.linear_units,
                                          c.positionwise_conv_kernel_size,
                                          c.dropout_rate)
            if c.positionwise_layer_type == "linear":
                return PositionwiseFeedForward(d, c.linear_units,
                                               c.activation_type,
                                               c.dropout_rate)
            raise NotImplementedError(c.positionwise_layer_type)

        self.macaron = c.macaron_style
        self.ff_scale = 0.5 if c.macaron_style else 1.0
        if c.macaron_style:
            self.norm_ff_macaron = nn.LayerNorm(d, eps=1e-5)
            self.feed_forward_macaron = positionwise()
        self.norm_mha = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = RelPositionMultiHeadedAttention(
            d, c.attention_heads, use_flash=c.use_flash_attention,
            dropout_rate=c.attention_dropout_rate)
        self.use_cnn = c.use_cnn_module
        if c.use_cnn_module:
            self.norm_conv = nn.LayerNorm(d, eps=1e-5)
            self.conv_module = ConvolutionModule(d, c.cnn_module_kernel,
                                                 c.activation_type)
            self.norm_final = nn.LayerNorm(d, eps=1e-5)
        self.norm_ff = nn.LayerNorm(d, eps=1e-5)
        self.feed_forward = positionwise()
        self.dropout = SeededDropout(c.dropout_rate)

    def forward(self, x, pos_emb, mask, generator=None):
        def drop(h):
            return self.dropout(h, generator)

        if self.macaron:
            x = x + self.ff_scale * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator))
        x = x + drop(self.self_attn(self.norm_mha(x), pos_emb, mask,
                                    generator))
        if self.use_cnn:
            x = x + drop(self.conv_module(self.norm_conv(x)))
        x = x + self.ff_scale * drop(self.feed_forward(self.norm_ff(x),
                                                       generator))
        if self.use_cnn:
            x = self.norm_final(x)
        return x


class ConformerStack(nn.Module):
    """num_blocks ConformerBlocks + the final LayerNorm."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.encoders = nn.ModuleList(ConformerBlock(c)
                                      for _ in range(c.num_blocks))
        self.after_norm = nn.LayerNorm(c.attention_dim, eps=1e-5)

    def forward(self, x, pos_emb, mask, generator=None):
        for block in self.encoders:
            x = block(x, pos_emb, mask, generator)
        return self.after_norm(x)
