"""Multi-head attention with (legacy) relative positional encoding, and
plain scaled dot-product attention (``a3t_tpu/models/attention.py``).

scores = ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_k); masked columns
get the dtype minimum before the softmax and are re-zeroed after.  The flash
branch hands the rel-shifted positional scores to the fused kernels
(``ops/fused_attention.py``: K1 forward, K2 backward) as an additive bias,
with the attention dropout drawn inside the kernels; the plain branch is the
JAX package's XLA branch (attention.py:179-194), which drops the
probabilities with :class:`SeededDropout`.

With a compute ``dtype`` (bfloat16) the casts are the JAX module's: the
projections run in that dtype (flax ``Dense(dtype=...)``), ``pos_emb`` and
the positional biases take it, the score products accumulate in float32,
the kernels take q, k, v and the bias in bfloat16, and the plain branch
keeps the softmax in float32 and stores, drops and multiplies the
probabilities in bfloat16 (attention.py:122-191).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from a3t_tpu_torch.models.dropout import SeededDropout, draw_seed
from a3t_tpu_torch.models.layers import dense
from a3t_tpu_torch.ops.fused_attention import fused_attention


def legacy_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift of (B, H, T1, T2) scores."""
    b, h, t1, t2 = x.shape
    xp = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1)
    return xp.view(b, h, t2 + 1, t1)[:, :, 1:].reshape(b, h, t1, t2)


def latest_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """New-style shift of a (B, H, T, 2T-1) score matrix."""
    b, h, t1, t2 = x.shape
    xp = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1)
    xp = xp.view(b, h, t2 + 1, t1)[:, :, 1:].reshape(b, h, t1, t2)
    return xp[..., : t2 // 2 + 1]


def apply_attn_mask(scores: torch.Tensor, mask) -> torch.Tensor:
    """Softmax with masked columns forced to zero probability.

    mask: (B, 1, T2) or (B, T1, T2); 0 = masked out.
    """
    if mask is None:
        return torch.softmax(scores, dim=-1)
    m = (mask != 0)[:, None] if mask.dim() == 3 else (mask != 0)
    scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
    return torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)


class MultiHeadedAttention(nn.Module):
    """Plain scaled dot-product self-attention (attention.py:67-97), the
    ``selfattn`` kind of the transformer FastSpeech2 stacks: masked columns
    get the dtype minimum before the float32 softmax and are re-zeroed
    after; the probabilities are dropped with :class:`SeededDropout` in
    training mode.  No fused kernel: the JAX module has none either."""

    def __init__(self, d_model: int, n_head: int, dropout_rate: float = 0.0,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.h = n_head
        self.d_k = d_model // n_head
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.dropout = SeededDropout(dropout_rate)
        # called with the plain branch's float32 probabilities, before
        # dropout (the attention plots; JAX sows them, attention.py:90-92)
        self.capture = None

    def heads(self, linear, y):
        """A projection in the compute dtype, split into (..., H, d_k)."""
        y = dense(linear, y, self.dtype)
        return y.view(*y.shape[:-1], self.h, self.d_k)

    def forward(self, query, key, value, mask=None, generator=None):
        b, t, d_model = query.shape
        dt = self.dtype
        q = self.heads(self.linear_q, query)
        k = self.heads(self.linear_k, key)
        v = self.heads(self.linear_v, value)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
            / math.sqrt(self.d_k)
        attn = apply_attn_mask(scores, mask)
        if self.capture is not None:
            self.capture(attn.detach())
        attn = self.dropout(attn, generator)
        out = torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)
        return dense(self.linear_out, out.reshape(b, t, d_model), dt)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Self-attention with relative positional encoding.

    ``legacy=True``: pos_emb of length T over reversed positions;
    ``legacy=False``: the 2T-1 "latest" variant.  ``use_flash`` routes the
    softmax and P.V through the fused kernels when the mask is per key.
    In training mode the attention probabilities are dropped at
    ``dropout_rate``, with seeds from the ``generator`` given to forward.
    """

    def __init__(self, d_model: int, n_head: int, legacy: bool = True,
                 use_flash: bool = True, dropout_rate: float = 0.0,
                 dtype=None):
        super().__init__(d_model, n_head, dropout_rate, dtype)
        self.legacy = legacy
        self.use_flash = use_flash
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k))

    def forward(self, x, pos_emb, mask=None, generator=None):
        b, t, d_model = x.shape

        dt = self.dtype
        if dt is not None:
            pos_emb = pos_emb.to(dt)

        q = self.heads(self.linear_q, x)
        k = self.heads(self.linear_k, x)
        v = self.heads(self.linear_v, x)
        p = self.heads(self.linear_pos, pos_emb)  # (1, P, H, d_k)
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)

        # the score products accumulate in float32 (preferred_element_type)
        matrix_bd = torch.einsum("bthd,bshd->bhts", q_v.float(),
                                 p.float().expand(b, *p.shape[1:]))
        matrix_bd = (legacy_rel_shift(matrix_bd) if self.legacy
                     else latest_rel_shift(matrix_bd))

        flat_mask = None
        if mask is not None:
            m3 = mask if mask.dim() == 3 else mask[:, None, :]
            if m3.shape[1] == 1:
                flat_mask = m3[:, 0] != 0

        if self.use_flash and (mask is None or flat_mask is not None):
            if flat_mask is None:
                flat_mask = torch.ones(b, t, dtype=torch.bool, device=x.device)
            rate = self.dropout.rate if self.training else 0.0
            seed = 0
            if rate > 0.0:
                if generator is None:
                    raise ValueError(
                        "attention dropout in training mode needs a generator")
                seed = draw_seed(generator)
            out = fused_attention(
                q_u.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(),
                matrix_bd.to(q_u.dtype).contiguous(), flat_mask,
                dropout_rate=rate, seed=seed)
            out = out.to(v.dtype).transpose(1, 2).reshape(b, t, d_model)
            return dense(self.linear_out, out, dt)

        matrix_ac = torch.einsum("bthd,bshd->bhts", q_u.float(), k.float())
        attn = apply_attn_mask((matrix_ac + matrix_bd) / math.sqrt(self.d_k),
                               mask)
        if self.capture is not None:
            self.capture(attn.detach())
        # the softmax stays float32; the probabilities are stored, dropped
        # and multiplied with v in the compute dtype
        attn = self.dropout(attn.to(v.dtype), generator)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, d_model)
        return dense(self.linear_out, out, dt)
