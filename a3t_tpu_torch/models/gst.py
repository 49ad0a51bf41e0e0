"""Global Style Token encoder (``a3t_tpu/models/gst.py``; reference
espnet2/tts/gst/style_encoder.py:16-273).

Reference mel -> six strided Conv2d + BatchNorm + ReLU -> GRU -> attention
over learned style tokens.  Parameter names are ESPnet's (``ref_enc.convs``
as a Sequential of conv, norm and ReLU, ``ref_enc.gru``, ``stl.gst_embs``,
``stl.mha``), which ``a3t_tpu/compat/fs2_import.py::_gst`` maps onto the
flax tree.  The GRU is torch's ``nn.GRU`` (cuDNN on the card): JAX's
recurrence, a GRUCell scanned over time, has no kernel of its own.  Its
hidden-side r and z biases take no gradient (flax folds them into the
input side), so a training step moves what JAX's moves.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from a3t_tpu_torch.models.layers import batch_norm


class ReferenceEncoder(nn.Module):
    """(B, T, idim) mel -> (B, gru_units), the GRU's last state over every
    frame (padding included, as in JAX).

    Each Conv2d has stride 2 and symmetric padding (k - 1) // 2 and no
    bias; each BatchNorm takes flax's momentum 0.9 (torch's 0.1) and, in
    training mode, flax's batch statistics (``layers.batch_norm``).  The
    GRU reads (B, T', C * F'), channels before frequency, as ESPnet's view
    does (gst.py:44-46)."""

    def __init__(self, idim: int = 80,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_units: int = 128):
        super().__init__()
        pad = (conv_kernel_size - 1) // 2
        layers = []
        for i, chans in enumerate(conv_chans_list):
            layers += [nn.Conv2d(1 if i == 0 else conv_chans_list[i - 1],
                                 chans, conv_kernel_size, stride=conv_stride,
                                 padding=pad, bias=False),
                       nn.BatchNorm2d(chans, eps=1e-5), nn.ReLU()]
        self.convs = nn.Sequential(*layers)
        f = idim
        for _ in conv_chans_list:
            f = (f - conv_kernel_size + 2 * pad) // conv_stride + 1
        self.gru = nn.GRU(conv_chans_list[-1] * f, gru_units,
                          batch_first=True)
        # flax's GRUCell has one bias for each of the r and z gates (torch's
        # b_ir + b_hr folded); the hidden side's r and z rows take no
        # gradient, so training moves the same parameters as in JAX
        hold = torch.ones(3 * gru_units)
        hold[: 2 * gru_units] = 0.0
        self.register_buffer("_bias_hh_grad", hold, persistent=False)
        self.gru.bias_hh_l0.register_hook(lambda g: g * self._bias_hh_grad)

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        h = speech[:, None]  # (B, 1, T, F)
        for i in range(0, len(self.convs), 3):
            conv, bn, relu = self.convs[i: i + 3]
            h = relu(batch_norm(bn, conv(h)))
        b, c, t, f = h.shape
        h = h.transpose(1, 2).reshape(b, t, c * f)
        _, last = self.gru(h)
        return last[0]


class StyleTokenAttention(nn.Module):
    """The token layer's multi-head attention (ESPnet's ``stl.mha``): one
    query per utterance over the tanh'd tokens, no mask, no dropout."""

    def __init__(self, q_dim: int, k_dim: int, n_feat: int, n_head: int):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.linear_q = nn.Linear(q_dim, n_feat)
        self.linear_k = nn.Linear(k_dim, n_feat)
        self.linear_v = nn.Linear(k_dim, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, query, tokens):
        b, n = query.shape[0], tokens.shape[1]
        q = self.linear_q(query).view(b, 1, self.h, self.d_k)
        k = self.linear_k(tokens).view(b, n, self.h, self.d_k)
        v = self.linear_v(tokens).view(b, n, self.h, self.d_k)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
        return self.linear_out(out.reshape(b, 1, self.h * self.d_k))[:, 0]


class StyleTokenLayer(nn.Module):
    """Reference embedding -> style embedding (style_encoder.py:194-252):
    attention over ``gst_tokens`` learned tokens of width
    gst_token_dim / gst_heads."""

    def __init__(self, ref_embed_dim: int = 128, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4):
        super().__init__()
        d_k = gst_token_dim // gst_heads
        self.gst_embs = nn.Parameter(torch.randn(gst_tokens, d_k))
        self.mha = StyleTokenAttention(ref_embed_dim, d_k, gst_token_dim,
                                       gst_heads)

    def forward(self, ref_embs):
        tokens = torch.tanh(self.gst_embs)[None].expand(
            ref_embs.shape[0], -1, -1)
        return self.mha(ref_embs, tokens)


class StyleEncoder(nn.Module):
    """(B, T, idim) mel -> (B, gst_token_dim) style embedding."""

    def __init__(self, idim: int = 80, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_units: int = 128):
        super().__init__()
        self.ref_enc = ReferenceEncoder(idim, conv_chans_list,
                                        conv_kernel_size, conv_stride,
                                        gru_units)
        self.stl = StyleTokenLayer(gru_units, gst_tokens, gst_token_dim,
                                   gst_heads)

    def forward(self, speech):
        return self.stl(self.ref_enc(speech))
