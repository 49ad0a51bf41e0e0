"""Sliding-window (Longformer-style) attention with global text tokens
(``a3t_tpu/models/windowed_attention.py``).

The sequence is ``[speech (n_frames) ; text]``.  Speech queries attend a
+/- window/2 band of speech frames plus every text token, through the banded
kernels (``ops/banded_attention.py``: K3 forward, K4 and K5 backward) with
the attention dropout drawn inside them; text queries attend everything, by
one full softmax, :class:`SeededDropout` on the probabilities and a plain
matrix product, as the JAX module computes them outside any Pallas kernel
(:201-209).  ``n_frames`` must be a multiple of window/2 (the batcher's
bucket rule).  The q/k/v/out projections run in the compute dtype (``dtype``,
flax ``Dense(dtype=...)``); scores and softmax are float32.

The JAX module's chunked-einsum path (``use_pallas=False``) and attention
dilation are not ported.  The chunked path differs from the Pallas kernels
only on query rows whose every key is masked (see ``ops/banded_attention``);
this module follows the kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from a3t_tpu_torch.models.dropout import SeededDropout, draw_seed
from a3t_tpu_torch.models.layers import dense
from a3t_tpu_torch.ops.banded_attention import banded_attention


class WindowedSelfAttention(nn.Module):
    """MHA where the first ``n_frames`` tokens use a +/- window/2 band and the
    rest (text) are global.  forward(x (B, T, d_model), n_frames, mask (B, T)
    validity, generator) -> (B, T, d_model) in the compute dtype."""

    def __init__(self, d_model: int, n_head: int, window: int,
                 dropout_rate: float = 0.0, dtype=None):
        super().__init__()
        if window < 2:
            raise ValueError(f"attention window {window} below 2")
        self.h = n_head
        self.d_k = d_model // n_head
        self.window = window
        self.dtype = dtype
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.dropout = SeededDropout(dropout_rate)

    def forward(self, x, n_frames: int, mask=None, generator=None):
        b, t, d_model = x.shape
        c = self.window // 2
        if n_frames % c != 0:
            raise ValueError(f"n_frames {n_frames} must be a multiple of "
                             f"half-window {c}")

        def heads(linear):  # (B, H, T, d_k)
            y = dense(linear, x, self.dtype)
            return y.view(b, t, self.h, self.d_k).transpose(1, 2)

        q, k, v = heads(self.linear_q), heads(self.linear_k), \
            heads(self.linear_v)
        if mask is None:
            mask = torch.ones(b, t, dtype=torch.bool, device=x.device)
        mask = mask != 0

        rate = self.dropout.rate if self.training else 0.0
        seed = 0
        if rate > 0.0:
            if generator is None:
                raise ValueError(
                    "attention dropout in training mode needs a generator")
            seed = draw_seed(generator)
        sp, tx = slice(0, n_frames), slice(n_frames, t)
        out_sp = banded_attention(
            q[:, :, sp].contiguous(), k[:, :, sp].contiguous(),
            v[:, :, sp].contiguous(), k[:, :, tx].contiguous(),
            v[:, :, tx].contiguous(), mask[:, tx], self.window,
            speech_mask=mask[:, sp], dropout_rate=rate, seed=seed)

        # text queries: full attention over every key, in float32
        scale = float(np.float32(1.0 / math.sqrt(self.d_k)))
        scores = torch.matmul(q[:, :, tx].float(),
                              k.float().transpose(-1, -2)) * scale
        scores = scores.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        attn = self.dropout(torch.softmax(scores, dim=-1), generator)
        out_tx = torch.matmul(attn.to(v.dtype), v)

        out = torch.cat([out_sp, out_tx], dim=2).transpose(1, 2)
        return dense(self.linear_out, out.reshape(b, t, d_model), self.dtype)
