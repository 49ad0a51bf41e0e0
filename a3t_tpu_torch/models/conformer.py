"""Conformer encoder/decoder stacks (``a3t_tpu/models/conformer.py``).

The block takes every attention kind of the JAX package's stacks: legacy
rel-pos self-attention (the 24 kHz A3T block and the published conformer
FastSpeech2), the "latest" rel-pos variant with its 2T-1 table
(``rel_selfattn``), plain self-attention (``selfattn``, the transformer
FastSpeech2) and, for the 16 kHz longformer block, sliding-window attention
with global text tokens (dilated or not, through the banded kernels or
JAX's chunked einsums); macaron halves and the conv module are options.
All blocks are pre-LayerNorm, in float32 or bfloat16 compute;
``normalize_before: false`` drops only the stack's final LayerNorm, as in
JAX (conformer.py:271).  ``remat`` recomputes each block in the backward
pass and ``remat_attention`` the rel-pos self-attention alone
(:func:`rematerialized`).  Module names follow ESPnet's EncoderLayer
(conformer/encoder_layer.py) so state dicts map onto the JAX package's
tree.

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

from a3t_tpu_torch.models.attention import (
    MultiHeadedAttention,
    RelPositionMultiHeadedAttention,
)
from a3t_tpu_torch.models.dropout import SeededDropout
from a3t_tpu_torch.models.layers import (
    ConvolutionModule,
    MultiLayeredConv1d,
    PositionwiseFeedForward,
    running_stats_frozen,
    sinusoidal_table,
)
from a3t_tpu_torch.models.windowed_attention import WindowedSelfAttention


ATTENTION_KINDS = ("legacy_rel_selfattn", "rel_selfattn", "selfattn",
                   "longformer")
POSITIONWISE_KINDS = ("conv1d", "conv1d_shifted", "linear")


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
    # "conv1d" | "linear" | "conv1d_shifted" (JAX's lowering of conv1d as k
    # shifted matmuls, the same parameters: here the same convolution)
    positionwise_layer_type: str = "conv1d"
    # JAX's lowering of the depthwise convolution as k shifted multiply-adds
    # (the same parameters: here the same convolution)
    cnn_module_shifted: bool = False
    # the conv module's BatchNorm as flax's BatchNorm(dtype=compute dtype)
    # instead of the float32 round trip (only with a compute dtype)
    cnn_module_bn_compute_dtype: bool = False
    positionwise_conv_kernel_size: int = 3
    activation_type: str = "swish"
    # "legacy_rel_selfattn" | "rel_selfattn" | "selfattn" | "longformer"
    # (sliding window + global text)
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
    # recompute each block in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    # recompute only the rel-pos self-attention in the backward pass
    remat_attention: bool = False

    @property
    def dtype(self):
        """The compute dtype, None for float32 (flax's convention)."""
        return None if self.compute_dtype == "float32" else torch.bfloat16

    def check_supported(self) -> None:
        kind = self.selfattention_layer_type
        if kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown attention kind {kind!r}")
        if self.positionwise_layer_type not in POSITIONWISE_KINDS:
            raise ValueError("unknown positionwise_layer_type "
                             f"{self.positionwise_layer_type!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r} is not ported")


def rel_pos_table(t: int, d_model: int) -> np.ndarray:
    """The "latest" variant's symmetric (2T - 1, d) table: positions
    T - 1 .. -(T - 1) (embedding.py:173-244, conformer.py:126-129)."""
    pos = sinusoidal_table(t, d_model)
    neg = pos.copy()
    neg[:, 0::2] *= -1.0  # sin(-x) = -sin(x); cos part unchanged
    return np.concatenate([pos[::-1], neg[1:]], axis=0)


class RelPosEncoding(nn.Module):
    """x -> (dropout(x * sqrt(d)), dropout(pos_emb)), two separate draws.

    ``legacy=True`` has LegacyRelPositionalEncoding's quirk: the reversed
    table is built over ``max(T, max_len)`` positions and the first T rows
    are taken, so row i carries position ``max(T, max_len) - 1 - i``.
    Trained checkpoints depend on this table.  ``legacy=False`` takes the
    symmetric 2T - 1 table of :func:`rel_pos_table`.

    As in flax, ``x * np.float32(sqrt(d))`` promotes a bfloat16 ``x`` to
    float32, while the table takes ``x``'s dtype (conformer.py:130-131).
    """

    def __init__(self, d_model: int, dropout_rate: float = 0.0,
                 max_len: int = 5000, legacy: bool = True):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.legacy = legacy
        self.dropout = SeededDropout(dropout_rate)

    def forward(self, x, generator=None):
        t = x.shape[1]
        if self.legacy:
            pe = sinusoidal_table(max(t, self.max_len), self.d_model,
                                  reverse=True)[:t]
        else:
            pe = rel_pos_table(t, self.d_model)
        pos_emb = torch.tensor(pe, dtype=x.dtype, device=x.device)[None]
        y = x.to(torch.promote_types(x.dtype, torch.float32)) \
            * float(np.float32(math.sqrt(self.d_model)))
        return (self.dropout(y, generator), self.dropout(pos_emb, generator))


class AbsPosEncoding(nn.Module):
    """x -> (dropout(x * sqrt(d) + pe), None) (embedding.py:35-94); the None
    stands for the relative table that :class:`RelPosEncoding` returns, as
    the JAX model's ``_PosEnc`` does.

    ``scaled=True`` is ScaledPositionalEncoding (conformer.py:139-154, the
    FastSpeech2 stacks): x + alpha * pe with a learnable scalar ``alpha``
    (one at first), ``x`` not scaled by sqrt(d).

    As in flax, ``x * np.float32(sqrt(d))`` promotes a bfloat16 ``x`` to
    float32, and the table is rounded to ``x``'s dtype before it is added.
    """

    def __init__(self, d_model: int, dropout_rate: float = 0.0,
                 scaled: bool = False):
        super().__init__()
        self.d_model = d_model
        self.dropout = SeededDropout(dropout_rate)
        self.alpha = nn.Parameter(torch.ones(())) if scaled else None

    def forward(self, x, generator=None):
        pe = torch.tensor(sinusoidal_table(x.shape[1], self.d_model),
                          device=x.device)[None].to(x.dtype)
        if self.alpha is not None:
            y = x + self.alpha * pe
        else:
            y = x.float() * float(np.float32(math.sqrt(self.d_model))) + pe
        return self.dropout(y, generator), None


def rematerialized(fn, generator, *tensors):
    """``fn(*tensors)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward pass instead of stored,
    as flax's ``nn.remat`` does.  The recomputation must see the same
    dropout masks and leave the step as it found it, so it starts from the
    state the step's CPU ``generator`` had before the forward (checkpoint's
    ``preserve_rng_state`` restores only the global generators, which no
    dropout site here draws from), gives the generator back its state after
    the forward, and leaves BatchNorm's running statistics alone, whose
    second update ``nn.remat`` discards too."""
    from torch.utils.checkpoint import checkpoint

    before = None if generator is None else generator.get_state()
    first = True

    def run(*args):
        nonlocal first
        if first:
            first = False
            return fn(*args)
        after = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(before)
        try:
            with running_stats_frozen():
                return fn(*args)
        finally:
            if generator is not None:
                generator.set_state(after)

    return checkpoint(run, *tensors, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_on(module: nn.Module, flag: bool) -> bool:
    """Rematerialise only where a backward pass will follow."""
    return flag and module.training and torch.is_grad_enabled()


class ConformerBlock(nn.Module):
    """x += 1/2 drop(ff_macaron(LN(x))); x += drop(attn(LN(x)));
    x += drop(conv(LN(x))); x += 1/2 drop(ff(LN(x))); x = LN(x).

    The attention is rel-pos MHA (legacy or latest), plain MHA
    (``selfattn``, which takes no positional table), or for ``longformer``
    windowed attention over ``[speech (n_frames) ; text]`` with a flat key
    mask.  ``remat_attention`` recomputes the rel-pos attention in the
    backward pass (JAX applies it to that kind only, conformer.py:205-210)."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        c.check_supported()
        d = c.attention_dim

        def positionwise():
            if c.positionwise_layer_type == "linear":
                return PositionwiseFeedForward(d, c.linear_units,
                                               c.activation_type,
                                               c.dropout_rate, dtype=c.dtype)
            return MultiLayeredConv1d(d, c.linear_units,
                                      c.positionwise_conv_kernel_size,
                                      c.dropout_rate, dtype=c.dtype)

        self.macaron = c.macaron_style
        self.ff_scale = 0.5 if c.macaron_style else 1.0
        if c.macaron_style:
            self.norm_ff_macaron = nn.LayerNorm(d, eps=1e-5)
            self.feed_forward_macaron = positionwise()
        self.norm_mha = nn.LayerNorm(d, eps=1e-5)
        self.kind = c.selfattention_layer_type
        self.remat_attention = False
        if self.kind == "longformer":
            self.self_attn = WindowedSelfAttention(
                d, c.attention_heads, c.attention_window,
                c.attention_dropout_rate, dtype=c.dtype,
                dilation=c.attention_dilation,
                use_banded=c.use_pallas_attention)
        elif self.kind == "selfattn":
            self.self_attn = MultiHeadedAttention(
                d, c.attention_heads, c.attention_dropout_rate, dtype=c.dtype)
        else:
            self.self_attn = RelPositionMultiHeadedAttention(
                d, c.attention_heads,
                legacy=self.kind == "legacy_rel_selfattn",
                use_flash=c.use_flash_attention,
                dropout_rate=c.attention_dropout_rate, dtype=c.dtype)
            self.remat_attention = c.remat_attention
        self.use_cnn = c.use_cnn_module
        if c.use_cnn_module:
            self.norm_conv = nn.LayerNorm(d, eps=1e-5)
            self.conv_module = ConvolutionModule(
                d, c.cnn_module_kernel, c.activation_type, dtype=c.dtype,
                bn_compute_dtype=c.cnn_module_bn_compute_dtype)
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
        if self.kind == "longformer":
            flat_mask = mask[:, 0] if mask is not None and mask.dim() == 3 \
                else mask
            h = self.self_attn(h, h.shape[1] if n_frames is None else n_frames,
                               flat_mask, generator)
        elif self.kind == "selfattn":
            h = self.self_attn(h, h, h, mask, generator)
        elif _remat_on(self, self.remat_attention):
            h = rematerialized(
                lambda hh, pe, m: self.self_attn(hh, pe, m, generator),
                generator, h, pos_emb, mask)
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
    transformer/encoder.py:547-548) and so does ``normalize_before:
    false``.  ``remat`` recomputes each block in the backward pass."""

    def __init__(self, c: EncoderConfig, apply_final_norm: bool = True):
        super().__init__()
        self.encoders = nn.ModuleList(ConformerBlock(c)
                                      for _ in range(c.num_blocks))
        self.after_norm = (nn.LayerNorm(c.attention_dim, eps=1e-5)
                           if apply_final_norm and c.normalize_before
                           else None)
        self.remat = c.remat

    def forward(self, x, pos_emb, mask, generator=None, n_frames=None):
        for block in self.encoders:
            if _remat_on(self, self.remat):
                x = rematerialized(
                    lambda xx, pe, m, blk=block: blk(xx, pe, m, generator,
                                                     n_frames),
                    generator, x, pos_emb, mask)
            else:
                x = block(x, pos_emb, mask, generator, n_frames)
        return x if self.after_norm is None else self.after_norm(x)
