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

On a ``shard`` of the model axis (``parallel/``) a block runs its rank's
slice of the attention heads and of both feed-forwards' hidden units; each
of the three begins with the model group's copy and ends with its
all-reduce (``parallel/tensor.py``), and the conv module, the LayerNorms
and every residual stay replicated.  Under ``remat`` each rank of a model
group replays its block's collectives in the same order.

On a rank of the mesh's seq axis (``seq``, ``parallel/sequence.py``) a
stack runs on the rank's frame block and the whole text: the positional
tables are the whole sequence's (:class:`RelPosEncoding` takes the global
length), the attention all-gathers its keys and values, the
convolutions exchange their halos, BatchNorm reduces over the data and
seq axes, and every dropout keeps the rank's rows of one process's mask.
Under ``remat`` the ranks of a seq group replay those collectives in the
same order.  The longformer kind takes both axes: its rank's heads, and
its frame block, any part of the frames, with the whole chunks of c x
dilation frames that cover it and a halo chunk of keys on each side from
the neighbour blocks (``models/windowed_attention.py``).

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
from a3t_tpu_torch.parallel.tensor import ModelShard


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

    def check_supported(self, tensor_parallel: int = 1) -> None:
        """Raise for what the port does not take, over a model axis of
        ``tensor_parallel`` ranks."""
        kind = self.selfattention_layer_type
        if kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown attention kind {kind!r}")
        if tensor_parallel > 1:
            for what, n in (("attention_heads", self.attention_heads),
                            ("linear_units", self.linear_units)):
                if n % tensor_parallel:
                    raise ValueError(
                        f"mesh.tensor_parallel={tensor_parallel} does not "
                        f"divide {what}={n}")
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

    def forward(self, x, generator=None, seq=None):
        """``seq``: ``x`` holds the rank's rows of the seq axis
        (``parallel/sequence.py``); the table is then the whole sequence's
        and its dropout draws the whole table's mask."""
        t = x.shape[1] if seq is None else seq.length
        if self.legacy:
            pe = sinusoidal_table(max(t, self.max_len), self.d_model,
                                  reverse=True)[:t]
        else:
            pe = rel_pos_table(t, self.d_model)
        pos_emb = torch.tensor(pe, dtype=x.dtype, device=x.device)[None]
        y = x.to(torch.promote_types(x.dtype, torch.float32)) \
            * float(np.float32(math.sqrt(self.d_model)))
        rows = None if seq is None else seq.drop_rows(1, x.device)
        return (self.dropout(y, generator, rows),
                self.dropout(pos_emb, generator))


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

    def forward(self, x, generator=None, seq=None):
        """``seq``: ``x`` holds the rank's rows of the seq axis; they take
        their rows of the whole sequence's table."""
        rows = None
        if seq is None:
            pe = sinusoidal_table(x.shape[1], self.d_model)
        else:
            rows = seq.drop_rows(1, x.device)
            pe = sinusoidal_table(seq.length, self.d_model)[
                np.r_[seq.offset:seq.offset + seq.block,
                      seq.frames:seq.length]]
        pe = torch.tensor(pe, device=x.device)[None].to(x.dtype)
        if self.alpha is not None:
            y = x + self.alpha * pe
        else:
            y = x.float() * float(np.float32(math.sqrt(self.d_model))) + pe
        return self.dropout(y, generator, rows), None


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
    backward pass (JAX applies it to that kind only, conformer.py:205-210).
    ``shard``: the block's place on the model axis; ``forward``'s ``seq``:
    its rows on the seq axis, where ``pos_emb`` and ``mask`` are the whole
    sequence's (module docstring)."""

    def __init__(self, c: EncoderConfig, shard: ModelShard = ModelShard()):
        super().__init__()
        c.check_supported(shard.size)
        d = c.attention_dim

        def positionwise():
            if c.positionwise_layer_type == "linear":
                return PositionwiseFeedForward(d, c.linear_units,
                                               c.activation_type,
                                               c.dropout_rate, dtype=c.dtype,
                                               shard=shard)
            return MultiLayeredConv1d(d, c.linear_units,
                                      c.positionwise_conv_kernel_size,
                                      c.dropout_rate, dtype=c.dtype,
                                      shard=shard)

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
                use_banded=c.use_pallas_attention, shard=shard)
        elif self.kind == "selfattn":
            self.self_attn = MultiHeadedAttention(
                d, c.attention_heads, c.attention_dropout_rate, dtype=c.dtype,
                shard=shard)
        else:
            self.self_attn = RelPositionMultiHeadedAttention(
                d, c.attention_heads,
                legacy=self.kind == "legacy_rel_selfattn",
                use_flash=c.use_flash_attention,
                dropout_rate=c.attention_dropout_rate, dtype=c.dtype,
                shard=shard)
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

    def forward(self, x, pos_emb, mask, generator=None, n_frames=None,
                seq=None):
        rows = None if seq is None else seq.drop_rows(1, x.device)

        def drop(h):
            return self.dropout(h, generator, rows)

        if self.macaron:
            x = x + self.ff_scale * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator, seq))
        h = self.norm_mha(x)
        if self.kind == "longformer":
            flat_mask = mask[:, 0] if mask is not None and mask.dim() == 3 \
                else mask
            h = self.self_attn(h, h.shape[1] if n_frames is None else n_frames,
                               flat_mask, generator, seq)
        elif self.kind == "selfattn":
            h = self.self_attn(h, h, h, mask, generator, seq)
        elif _remat_on(self, self.remat_attention):
            h = rematerialized(
                lambda hh, pe, m: self.self_attn(hh, pe, m, generator, seq),
                generator, h, pos_emb, mask)
        else:
            h = self.self_attn(h, pos_emb, mask, generator, seq)
        x = x + drop(h)
        if self.use_cnn:
            x = x + drop(self.conv_module(self.norm_conv(x), seq))
        x = x + self.ff_scale * drop(self.feed_forward(self.norm_ff(x),
                                                       generator, seq))
        if self.use_cnn:
            x = self.norm_final(x)
        return x


class ConformerStack(nn.Module):
    """num_blocks ConformerBlocks + the final LayerNorm, which the
    speech-only pre-encoder leaves out (``apply_final_norm=False``,
    transformer/encoder.py:547-548) and so does ``normalize_before:
    false``.  ``remat`` recomputes each block in the backward pass.
    ``shard``: the blocks' place on the model axis; ``forward``'s ``seq``:
    the input's rows on the seq axis."""

    def __init__(self, c: EncoderConfig, apply_final_norm: bool = True,
                 shard: ModelShard = ModelShard()):
        super().__init__()
        self.encoders = nn.ModuleList(ConformerBlock(c, shard)
                                      for _ in range(c.num_blocks))
        self.after_norm = (nn.LayerNorm(c.attention_dim, eps=1e-5)
                           if apply_final_norm and c.normalize_before
                           else None)
        self.remat = c.remat

    def forward(self, x, pos_emb, mask, generator=None, n_frames=None,
                seq=None):
        for block in self.encoders:
            if _remat_on(self, self.remat):
                x = rematerialized(
                    lambda xx, pe, m, blk=block: blk(xx, pe, m, generator,
                                                     n_frames, seq),
                    generator, x, pos_emb, mask)
            else:
                x = block(x, pos_emb, mask, generator, n_frames, seq)
        return x if self.after_norm is None else self.after_norm(x)
