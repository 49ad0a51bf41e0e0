"""Sliding-window (Longformer-style) attention with global text tokens
(``a3t_tpu/models/windowed_attention.py``).

The sequence is ``[speech (n_frames) ; text]``.  Speech queries attend a
+/- window/2 band of speech frames plus every text token; text queries
attend everything, by one full softmax, :class:`SeededDropout` on the
probabilities and a plain matrix product (JAX :201-209).  The q/k/v/out
projections run in the compute dtype (``dtype``, flax ``Dense(dtype=...)``);
scores and softmax are float32.

The speech queries take one of two paths, as the JAX module's
``use_pallas`` chooses:

* ``use_banded=True``: the banded kernels (``ops/banded_attention.py``: K3
  forward, K4 and K5 backward) with the attention dropout drawn inside them;
* ``use_banded=False``: JAX's chunked einsums (:147-177): each query chunk
  against its three neighbour chunks, zeros for the missing edge
  neighbours, masked scores at the float32 minimum, one float32 softmax
  over [band ; text], :class:`SeededDropout` on the probabilities and the
  two products in the value dtype.

The two differ only on query rows whose every key is masked (see
``ops/banded_attention``).  ``dilation`` d > 1 (JAX :97-103, :179-199) lets
a speech query attend every d-th frame of a d-times wider band: frame
p * d + r of batch row bi goes to row bi * d + r at position p, the d phase
sequences run through the same path with the text keys repeated d times
(``repeat_interleave``, ``jnp.repeat``), and the output is put back in frame
order.  ``n_frames`` must be a multiple of window/2 x dilation (the
batcher's bucket rule).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from a3t_tpu_torch.models.dropout import SeededDropout, draw_seed
from a3t_tpu_torch.models.layers import dense
from a3t_tpu_torch.ops.banded_attention import banded_attention

NEG = torch.finfo(torch.float32).min


def chunk_bands(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, H, T, d) -> (B, H, nc, 3c, d): each chunk of c rows with its
    neighbours i-1, i, i+1; the missing edge neighbours are zeros (JAX
    ``_chunk_bands``)."""
    b, h, t, d = x.shape
    xc = x.reshape(b, h, t // c, c, d)
    zero = torch.zeros_like(xc[:, :, :1])
    return torch.cat([torch.cat([zero, xc[:, :, :-1]], 2), xc,
                      torch.cat([xc[:, :, 1:], zero], 2)], dim=3)


def band_valid(nc: int, c: int, device) -> torch.Tensor:
    """(nc, 3c) structurally valid band positions: chunk 0 has no previous
    chunk, chunk nc-1 no next one (JAX ``_band_valid``)."""
    valid = torch.ones(nc, 3 * c, dtype=torch.bool, device=device)
    valid[0, :c] = False
    valid[-1, 2 * c:] = False
    return valid


class WindowedSelfAttention(nn.Module):
    """MHA where the first ``n_frames`` tokens use a +/- window/2 band and the
    rest (text) are global.  forward(x (B, T, d_model), n_frames, mask (B, T)
    validity, generator) -> (B, T, d_model) in the compute dtype."""

    def __init__(self, d_model: int, n_head: int, window: int,
                 dropout_rate: float = 0.0, dtype=None, dilation: int = 1,
                 use_banded: bool = True):
        super().__init__()
        if window < 2:
            raise ValueError(f"attention window {window} below 2")
        if dilation < 1:
            raise ValueError(f"dilation must be >= 1, got {dilation}")
        self.h = n_head
        self.d_k = d_model // n_head
        self.window = window
        self.dilation = dilation
        self.use_banded = use_banded
        self.dtype = dtype
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.dropout = SeededDropout(dropout_rate)

    def _scale(self) -> float:
        return float(np.float32(1.0 / math.sqrt(self.d_k)))

    def _chunked(self, q, k, v, spm, k_tx, v_tx, txm, generator):
        """JAX's chunked-einsum speech attention on (B', H, F', d) phase
        tensors -> (B', H, F', d) in the value dtype."""
        bb, h, nf, d = q.shape
        c = self.window // 2
        nc = nf // c
        scale = self._scale()
        qc = q.reshape(bb, h, nc, c, d).float()
        vb = chunk_bands(v, c)
        band = torch.einsum("bhncd,bhnkd->bhnck", qc,
                            chunk_bands(k, c).float()) * scale
        key_ok = chunk_bands(spm[:, None, :, None].float(), c)[:, 0, ..., 0]
        band_ok = band_valid(nc, c, q.device)[None] & (key_ok > 0)
        band = band.masked_fill(~band_ok[:, None, :, None, :], NEG)
        text = torch.einsum("bhncd,bhsd->bhncs", qc, k_tx.float()) * scale
        text = text.masked_fill(~txm[:, None, None, None, :], NEG)
        attn = self.dropout(torch.softmax(torch.cat([band, text], -1), -1),
                            generator)
        a_band, a_text = attn[..., :3 * c], attn[..., 3 * c:]
        out = torch.einsum("bhnck,bhnkd->bhncd", a_band.to(v.dtype), vb) \
            + torch.einsum("bhncs,bhsd->bhncd", a_text.to(v.dtype), v_tx)
        return out.reshape(bb, h, nf, d)

    def forward(self, x, n_frames: int, mask=None, generator=None):
        b, t, d_model = x.shape
        c, dl = self.window // 2, self.dilation
        if n_frames % (c * dl) != 0:
            raise ValueError(f"n_frames {n_frames} must be a multiple of "
                             f"half-window {c} x dilation {dl}")

        def heads(linear):  # (B, H, T, d_k)
            y = dense(linear, x, self.dtype)
            return y.view(b, t, self.h, self.d_k).transpose(1, 2)

        q, k, v = heads(self.linear_q), heads(self.linear_k), \
            heads(self.linear_v)
        if mask is None:
            mask = torch.ones(b, t, dtype=torch.bool, device=x.device)
        mask = mask != 0

        sp, tx = slice(0, n_frames), slice(n_frames, t)
        q_sp, k_sp, v_sp, spm = q[:, :, sp], k[:, :, sp], v[:, :, sp], \
            mask[:, sp]
        k_tx, v_tx, txm = k[:, :, tx], v[:, :, tx], mask[:, tx]
        nf_p = n_frames // dl
        if dl > 1:
            # frame p * dl + r of row bi -> row bi * dl + r, position p
            def to_phases(y):
                return y.reshape(b, self.h, nf_p, dl, self.d_k).permute(
                    0, 3, 1, 2, 4).reshape(b * dl, self.h, nf_p, self.d_k)

            q_sp, k_sp, v_sp = to_phases(q_sp), to_phases(k_sp), \
                to_phases(v_sp)
            spm = spm.reshape(b, nf_p, dl).transpose(1, 2).reshape(
                b * dl, nf_p)
            k_tx, v_tx, txm = (y.repeat_interleave(dl, dim=0)
                               for y in (k_tx, v_tx, txm))

        if self.use_banded:
            rate = self.dropout.rate if self.training else 0.0
            seed = 0
            if rate > 0.0:
                if generator is None:
                    raise ValueError(
                        "attention dropout in training mode needs a "
                        "generator")
                seed = draw_seed(generator)
            out_sp = banded_attention(
                q_sp.contiguous(), k_sp.contiguous(), v_sp.contiguous(),
                k_tx.contiguous(), v_tx.contiguous(), txm, self.window,
                speech_mask=spm, dropout_rate=rate, seed=seed)
        else:
            out_sp = self._chunked(q_sp, k_sp, v_sp, spm, k_tx, v_tx, txm,
                                   generator)
        if dl > 1:
            out_sp = out_sp.reshape(b, dl, self.h, nf_p, self.d_k).permute(
                0, 2, 3, 1, 4).reshape(b, self.h, n_frames, self.d_k)

        # text queries: full attention over every key, in float32
        scores = torch.matmul(q[:, :, tx].float(),
                              k.float().transpose(-1, -2)) * self._scale()
        scores = scores.masked_fill(~mask[:, None, None, :], NEG)
        attn = self.dropout(torch.softmax(scores, dim=-1), generator)
        out_tx = torch.matmul(attn.to(v.dtype), v)

        out = torch.cat([out_sp, out_tx], dim=2).transpose(1, 2)
        return dense(self.linear_out, out.reshape(b, t, d_model), self.dtype)
