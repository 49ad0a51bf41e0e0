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

On a ``shard`` of the model axis (``parallel/sharding.py``) a module runs
its rank's H / tp heads, ``head0 .. head0 + H / tp - 1``: q, k, v and
``linear_pos`` hold their rows, ``pos_bias_u``/``pos_bias_v`` their rows,
``linear_out`` their columns, whose partial products the model group sums
before the bias (``layers.row_parallel``).  The positional scores and their
shift run on those heads alone; K1/K2 draw the dropout lanes of the
global heads (``head0``), and the plain branch keeps the matching slice of
one process's mask.

On a rank of the mesh's seq axis (``seq``, ``parallel/sequence.py``) a
module's queries are its rows, the frame block and the whole text: the
keys and values of the speech are all-gathered over the seq group in
global order and the local text rows appended, the positional table is
the whole sequence's, the relative shift takes the rank's rows
(:func:`legacy_rel_shift_rows`, with the next block's first row of
positional scores as a one-row halo; :func:`latest_rel_shift_rows`), and
K1/K2 run on the rank's query rows against every key (``q_rows``), so
that their dropout draws one process's bits for those rows.  The mask is
the whole sequence's key mask.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from a3t_tpu_torch.models.dropout import SeededDropout, draw_seed
from a3t_tpu_torch.models.layers import dense, row_parallel
from a3t_tpu_torch.ops.fused_attention import fused_attention
from a3t_tpu_torch.parallel.sequence import gather_frames, next_row
from a3t_tpu_torch.parallel.tensor import ModelShard, copy_to_model


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


def legacy_rel_shift_rows(x: torch.Tensor, x_next: torch.Tensor,
                          g0: int) -> torch.Tensor:
    """Rows ``g0 .. g0 + n - 1`` of :func:`legacy_rel_shift` of an (L, L)
    score matrix, from its unshifted rows ``x`` (B, H, n, L) and the row
    after them ``x_next`` (B, H, 1, L): row g reads ``x[g][L + j - g - 1]``
    for j <= g, 0 at j = g + 1 and ``x[g + 1][j - g - 2]`` after."""
    b, h, n, l = x.shape
    rows = torch.cat([x, x_next], dim=2)
    flat = torch.cat([rows.new_zeros(b, h, n + 1, 1), rows],
                     dim=-1).reshape(b, h, (n + 1) * (l + 1))
    return flat.narrow(-1, l - g0, n * l).view(b, h, n, l)


def latest_rel_shift_rows(x: torch.Tensor, g0: int) -> torch.Tensor:
    """Rows ``g0 .. g0 + n - 1`` of :func:`latest_rel_shift` of an (L, P)
    score matrix, from those rows ``x`` (B, H, n, P), P = 2L - 1 (or 2L - 2:
    the encoder's speech and text tables side by side): row g reads
    ``x[g][L - 1 - g + j]``, 0 past column P - 1."""
    b, h, n, t2 = x.shape
    l = t2 // 2 + 1
    flat = torch.cat([x.new_zeros(b, h, n, 1), x], dim=-1).reshape(
        b, h, n * (t2 + 1))
    flat = torch.cat([flat, flat.new_zeros(b, h, l)], dim=-1)
    return flat.narrow(-1, l - g0, n * t2).view(b, h, n, t2)[..., :l]


def _gathered(x: torch.Tensor, seq) -> torch.Tensor:
    """The whole sequence's rows of a projection ``x`` (B, block + tail,
    ...): the speech all-gathered over the seq group, then the local
    text."""
    if seq is None:
        return x
    return torch.cat([gather_frames(x[:, :seq.block], seq),
                      x[:, seq.block:]], dim=1)


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
                 dtype=None, shard: ModelShard = ModelShard()):
        super().__init__()
        self.dtype = dtype
        self.h = shard.part(n_head, "attention_heads")  # this rank's heads
        self.head0 = shard.rank * self.h
        self.tp = shard.size
        self.d_k = d_model // n_head
        width = self.h * self.d_k
        self.linear_q = nn.Linear(d_model, width)
        self.linear_k = nn.Linear(d_model, width)
        self.linear_v = nn.Linear(d_model, width)
        self.linear_out = nn.Linear(width, d_model)
        # the probabilities (B, H, T1, T2) hold this rank's heads
        self.dropout = SeededDropout(dropout_rate,
                                     (1, shard.rank, shard.size))
        # called with the plain branch's float32 probabilities, before
        # dropout (the attention plots; JAX sows them, attention.py:90-92)
        self.capture = None

    def heads(self, linear, y):
        """A projection in the compute dtype, split into (..., H, d_k)."""
        y = dense(linear, y, self.dtype)
        return y.view(*y.shape[:-1], self.h, self.d_k)

    def forward(self, query, key, value, mask=None, generator=None,
                seq=None):
        b, t, _ = query.shape
        dt = self.dtype
        if self.tp > 1:
            if key is query and value is query:  # self-attention: one copy
                query = key = value = copy_to_model(query, self.tp)
            else:
                query, key, value = (copy_to_model(x, self.tp)
                                     for x in (query, key, value))
        q = self.heads(self.linear_q, query)
        k = _gathered(self.heads(self.linear_k, key), seq)
        v = _gathered(self.heads(self.linear_v, value), seq)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
            / math.sqrt(self.d_k)
        attn = apply_attn_mask(scores, mask)
        if self.capture is not None:
            self.capture(attn.detach())
        attn = self.dropout(attn, generator, None if seq is None
                            else seq.drop_rows(2, attn.device))
        out = torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)
        return row_parallel(self.linear_out,
                            out.reshape(b, t, self.h * self.d_k), dt, self.tp)


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
                 dtype=None, shard: ModelShard = ModelShard()):
        super().__init__(d_model, n_head, dropout_rate, dtype, shard)
        self.legacy = legacy
        self.use_flash = use_flash
        self.linear_pos = nn.Linear(d_model, self.h * self.d_k, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(self.h, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(self.h, self.d_k))

    def forward(self, x, pos_emb, mask=None, generator=None, seq=None):
        """``seq``: the rank's rows on the seq axis (module docstring);
        ``pos_emb`` and ``mask`` are then the whole sequence's."""
        b, t, _ = x.shape
        width = self.h * self.d_k

        dt = self.dtype
        if dt is not None:
            pos_emb = pos_emb.to(dt)
        x = copy_to_model(x, self.tp)

        q = self.heads(self.linear_q, x)
        k = _gathered(self.heads(self.linear_k, x), seq)
        v = _gathered(self.heads(self.linear_v, x), seq)
        p = self.heads(self.linear_pos, pos_emb)  # (1, P, H, d_k)
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)

        # the score products accumulate in float32 (preferred_element_type)
        pf = p.float().expand(b, *p.shape[1:])
        matrix_bd = torch.einsum("bthd,bshd->bhts", q_v.float(), pf)
        if seq is None:
            matrix_bd = (legacy_rel_shift(matrix_bd) if self.legacy
                         else latest_rel_shift(matrix_bd))
        else:
            matrix_bd = self._shift_rows(matrix_bd, q_v, pf, seq)
        t_k = k.shape[1]

        flat_mask = None
        if mask is not None:
            m3 = mask if mask.dim() == 3 else mask[:, None, :]
            if m3.shape[1] == 1:
                flat_mask = m3[:, 0] != 0

        if self.use_flash and (mask is None or flat_mask is not None):
            if flat_mask is None:
                flat_mask = torch.ones(b, t_k, dtype=torch.bool,
                                       device=x.device)
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
                dropout_rate=rate, seed=seed, head0=self.head0,
                q_rows=None if seq is None else seq.q_rows())
            out = out.to(v.dtype).transpose(1, 2).reshape(b, t, width)
            return row_parallel(self.linear_out, out, dt, self.tp)

        matrix_ac = torch.einsum("bthd,bshd->bhts", q_u.float(), k.float())
        attn = apply_attn_mask((matrix_ac + matrix_bd) / math.sqrt(self.d_k),
                               mask)
        if self.capture is not None:
            self.capture(attn.detach())
        # the softmax stays float32; the probabilities are stored, dropped
        # and multiplied with v in the compute dtype
        attn = self.dropout(attn.to(v.dtype), generator, None if seq is None
                            else seq.drop_rows(2, attn.device))
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, width)
        return row_parallel(self.linear_out, out, dt, self.tp)

    def _shift_rows(self, bd, q_v, pf, seq):
        """The rank's rows of the relative shift of the whole sequence's
        positional scores, from its unshifted rows ``bd`` (B, H, block +
        tail, P): the frame block (global rows from ``seq.offset``), then
        the text (from ``seq.frames``).  The legacy shift's last frame reads
        the next row's scores: the next block's first row of ``q_v``
        (``parallel/sequence.py::next_row``) against the table."""
        n = seq.block
        speech, text = bd[:, :, :n], bd[:, :, n:]
        if not self.legacy:
            return torch.cat([latest_rel_shift_rows(speech, seq.offset),
                              latest_rel_shift_rows(text, seq.frames)], 2)
        q_next = next_row(q_v, seq)  # (B, 1, H, d_k)
        bd_next = torch.einsum("bthd,bshd->bhts", q_next.float(), pf)
        # the text's last row reads no next row
        return torch.cat([
            legacy_rel_shift_rows(speech, bd_next, seq.offset),
            legacy_rel_shift_rows(text, torch.zeros_like(bd_next),
                                  seq.frames)], 2)
