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
order.  ``n_frames`` (on the seq axis the whole sequence's frames) must be
a multiple of window/2 x dilation (the batcher's bucket rule).

On a ``shard`` of the model axis (``parallel/tensor.py``) the module runs
its rank's H / tp heads from ``head0``: q, k and v hold their rows,
``linear_out`` their columns, whose partial products the model group sums
(``layers.row_parallel``); the banded kernels draw the dropout lanes of
the global heads, and both dropout sites keep their heads' slice of one
process's mask.

On a rank of the mesh's seq axis (``seq``, ``parallel/sequence.py``) the
module holds its frame block and the whole text, and ``mask`` is the whole
sequence's key mask.  The block may be any part of the frames, as JAX's
GSPMD takes it: the speech queries run on the whole chunks of c x d frames
that cover the block (:func:`cover`), with one halo chunk of keys and
values on each side, which is c positions of each phase.  The rows outside
the block come from the neighbour blocks through one
``parallel/sequence.py::halo_pad`` of q, k and v over the frames alone
(zeros at the global edges; nearer blocks than the halo are whole in it),
and the rank keeps its own rows: the others get a zero output gradient,
so they add nothing to dq, to the band keys' dk/dv or to the text keys'.
The chunks are placed in one process's call (``chunks`` of the banded
kernels; the chunked path bands over the halo'd tensors with the
structural edges of the whole sequence and keeps its chunks' rows of one
process's dropout mask), so two ranks that compute one chunk draw the
same bits.  The text queries attend every key, so the speech keys and
values are all-gathered and the local text appended; their dropout mask
is the whole tensor's, the same on every rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from a3t_tpu_torch.models.dropout import SeededDropout, draw_seed
from a3t_tpu_torch.models.layers import dense, row_parallel
from a3t_tpu_torch.ops.banded_attention import banded_attention
from a3t_tpu_torch.parallel.sequence import gather_frames, halo_pad
from a3t_tpu_torch.parallel.tensor import ModelShard, copy_to_model

NEG = torch.finfo(torch.float32).min


def chunk_bands(x: torch.Tensor, c: int, halo: bool = False) -> torch.Tensor:
    """(B, H, T, d) -> (B, H, nc, 3c, d): each chunk of c rows with its
    neighbours i-1, i, i+1; the missing edge neighbours are zeros (JAX
    ``_chunk_bands``).  ``halo``: x holds a halo chunk on each side, (B, H,
    T + 2c, d), which stands for the edge chunks' neighbours."""
    b, h, t, d = x.shape
    xc = x.reshape(b, h, t // c, c, d)
    if halo:
        return torch.cat([xc[:, :, :-2], xc[:, :, 1:-1], xc[:, :, 2:]], dim=3)
    zero = torch.zeros_like(xc[:, :, :1])
    return torch.cat([torch.cat([zero, xc[:, :, :-1]], 2), xc,
                      torch.cat([xc[:, :, 1:], zero], 2)], dim=3)


def band_valid(nc: int, c: int, device, chunk0: int = 0,
               nc_all: int = None) -> torch.Tensor:
    """(nc, 3c) structurally valid band positions of the query chunks
    chunk0 .. chunk0 + nc - 1 of nc_all (default nc): chunk 0 has no
    previous chunk, chunk nc_all - 1 no next one (JAX ``_band_valid``)."""
    nc_all = nc if nc_all is None else nc_all
    valid = torch.ones(nc, 3 * c, dtype=torch.bool, device=device)
    if chunk0 == 0:
        valid[0, :c] = False
    if chunk0 + nc == nc_all:
        valid[-1, 2 * c:] = False
    return valid


def cover(seq, unit: int) -> tuple:
    """(lo, hi, halo): the whole chunks of ``unit`` frames that cover seq
    rank ``seq.rank``'s block, frames [lo, hi), and the halo rows that
    every rank of the seq group pads its block with (a collective, so the
    same on every rank) for one more chunk on each side of its cover."""
    blk = seq.block
    ends = [(s * blk // unit * unit, -(-(s + 1) * blk // unit) * unit)
            for s in range(seq.size)]
    halo = unit + max(max(s * blk - lo, hi - (s + 1) * blk)
                      for s, (lo, hi) in enumerate(ends))
    return (*ends[seq.rank], halo)


class WindowedSelfAttention(nn.Module):
    """MHA where the first ``n_frames`` tokens use a +/- window/2 band and the
    rest (text) are global.  forward(x (B, T, d_model), n_frames, mask (B, T)
    validity, generator, seq) -> (B, T, d_model) in the compute dtype.
    ``shard``: the module's place on the model axis."""

    def __init__(self, d_model: int, n_head: int, window: int,
                 dropout_rate: float = 0.0, dtype=None, dilation: int = 1,
                 use_banded: bool = True, shard: ModelShard = ModelShard()):
        super().__init__()
        if window < 2:
            raise ValueError(f"attention window {window} below 2")
        if dilation < 1:
            raise ValueError(f"dilation must be >= 1, got {dilation}")
        self.h = shard.part(n_head, "attention_heads")  # this rank's heads
        self.heads = n_head
        self.head0 = shard.rank * self.h
        self.tp = shard.size
        self.d_k = d_model // n_head
        self.window = window
        self.dilation = dilation
        self.use_banded = use_banded
        self.dtype = dtype
        width = self.h * self.d_k
        self.linear_q = nn.Linear(d_model, width)
        self.linear_k = nn.Linear(d_model, width)
        self.linear_v = nn.Linear(d_model, width)
        self.linear_out = nn.Linear(width, d_model)
        # both sites' probabilities hold this rank's heads along dim 1
        self.dropout = SeededDropout(dropout_rate,
                                     (1, shard.rank, shard.size))

    def _scale(self) -> float:
        return float(np.float32(1.0 / math.sqrt(self.d_k)))

    def _chunked(self, q, k, v, spm, k_tx, v_tx, txm, generator,
                 chunks=None):
        """JAX's chunked-einsum speech attention on (B', H, F', d) phase
        tensors -> (B', H, F', d) in the value dtype.  ``chunks = (chunk0,
        nc_all)``: the queries are chunks chunk0 .. of nc_all, and k, v and
        spm carry a halo chunk on each side."""
        bb, h, nf, d = q.shape
        c = self.window // 2
        nc = nf // c
        halo = chunks is not None
        chunk0, nc_all = chunks if halo else (0, nc)
        scale = self._scale()
        qc = q.reshape(bb, h, nc, c, d).float()
        vb = chunk_bands(v, c, halo)
        band = torch.einsum("bhncd,bhnkd->bhnck", qc,
                            chunk_bands(k, c, halo).float()) * scale
        key_ok = chunk_bands(spm[:, None, :, None].float(), c, halo)[
            :, 0, ..., 0]
        band_ok = band_valid(nc, c, q.device, chunk0, nc_all)[None] \
            & (key_ok > 0)
        band = band.masked_fill(~band_ok[:, None, :, None, :], NEG)
        text = torch.einsum("bhncd,bhsd->bhncs", qc, k_tx.float()) * scale
        text = text.masked_fill(~txm[:, None, None, None, :], NEG)
        rows = None if not halo else (
            2, torch.arange(chunk0, chunk0 + nc, device=q.device), nc_all)
        attn = self.dropout(torch.softmax(torch.cat([band, text], -1), -1),
                            generator, rows)
        a_band, a_text = attn[..., :3 * c], attn[..., 3 * c:]
        out = torch.einsum("bhnck,bhnkd->bhncd", a_band.to(v.dtype), vb) \
            + torch.einsum("bhncs,bhsd->bhncd", a_text.to(v.dtype), v_tx)
        return out.reshape(bb, h, nf, d)

    def forward(self, x, n_frames: int, mask=None, generator=None, seq=None):
        """``seq``: the rank's rows on the seq axis (module docstring):
        ``x`` holds its frame block (``n_frames`` rows) and the text, and
        ``mask`` is the whole sequence's."""
        b, t, d_model = x.shape
        c, dl = self.window // 2, self.dilation
        cd = c * dl
        frames = n_frames if seq is None else seq.frames
        if frames % cd != 0:
            raise ValueError(f"n_frames {frames} must be a multiple of "
                             f"half-window {c} x dilation {dl}")
        x = copy_to_model(x, self.tp)

        def heads(linear):  # (B, T, H, d_k)
            return dense(linear, x, self.dtype).view(b, t, self.h, self.d_k)

        q, k, v = heads(self.linear_q), heads(self.linear_k), \
            heads(self.linear_v)
        if mask is None:
            mask = torch.ones(b, t, dtype=torch.bool, device=x.device)
        mask = mask != 0

        sp, tx = slice(0, n_frames), slice(n_frames, t)
        if seq is None:
            spm, txm, key_mask = mask[:, sp], mask[:, tx], mask
            q_sp, k_sp, v_sp, chunks = q[:, sp], k[:, sp], v[:, sp], None
            lo, hi = 0, n_frames
        else:
            # the covering chunks' queries, with a chunk of keys and values
            # on each side, out of one halo exchange of q, k and v (zeros
            # past the global edges; the backward returns each halo row's
            # gradient to its owner)
            lo, hi, halo = cover(seq, cd)
            at = halo - (seq.offset - lo)  # frame lo in the padded block
            qkv = halo_pad(torch.cat([q[:, sp], k[:, sp], v[:, sp]], -1),
                           halo, seq.speech(), 1)
            q_sp = qkv[:, at:at + hi - lo, :, :self.d_k]
            k_sp, v_sp = qkv[:, at - cd:at + hi - lo + cd].split(
                self.d_k, -1)[1:]
            edge = mask.new_zeros(b, cd)
            spm = torch.cat([edge, mask[:, :seq.frames], edge], 1)[
                :, lo:hi + 2 * cd]
            txm = mask[:, seq.frames:]
            # text queries attend the whole sequence's keys
            key_mask = mask if t > n_frames else \
                mask[:, seq.offset:seq.offset + seq.block]
            chunks = (lo // cd, seq.frames // cd)
        nf_p = (hi - lo) // dl

        def to_phases(y):  # (B, F, H, d_k) -> (B * dl, H, F / dl, d_k)
            f = y.shape[1]
            return y.reshape(b, f // dl, dl, self.h, self.d_k).permute(
                0, 2, 3, 1, 4).reshape(b * dl, self.h, f // dl, self.d_k)

        # frame p * dl + r of row bi -> row bi * dl + r, position p
        q_sp, k_sp, v_sp = (to_phases(y) for y in (q_sp, k_sp, v_sp))
        spm = spm.reshape(b, -1, dl).transpose(1, 2).reshape(b * dl, -1)
        k_tx, v_tx = (y[:, tx].transpose(1, 2).repeat_interleave(dl, dim=0)
                      for y in (k, v))
        txm_p = txm.repeat_interleave(dl, dim=0)

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
                k_tx.contiguous(), v_tx.contiguous(), txm_p, self.window,
                speech_mask=spm, dropout_rate=rate, seed=seed,
                head0=self.head0, heads=self.heads, chunks=chunks)
        else:
            out_sp = self._chunked(q_sp, k_sp, v_sp, spm, k_tx, v_tx, txm_p,
                                   generator, chunks)
        # back to frame order, the rank's own rows of its cover
        out_sp = out_sp.reshape(b, dl, self.h, nf_p, self.d_k).permute(
            0, 2, 3, 1, 4).reshape(b, self.h, hi - lo, self.d_k)
        if seq is not None:
            out_sp = out_sp.narrow(2, seq.offset - lo, n_frames)

        # text queries: full attention over every key, in float32
        if seq is not None and t > n_frames:
            k, v = (torch.cat([gather_frames(y[:, sp], seq), y[:, tx]], 1)
                    for y in (k, v))
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        scores = torch.matmul(q[:, tx].transpose(1, 2).float(),
                              k.float().transpose(-1, -2)) * self._scale()
        scores = scores.masked_fill(~key_mask[:, None, None, :], NEG)
        attn = self.dropout(torch.softmax(scores, dim=-1), generator)
        out_tx = torch.matmul(attn.to(v.dtype), v)

        out = torch.cat([out_sp, out_tx], dim=2).transpose(1, 2)
        return row_parallel(self.linear_out,
                            out.reshape(b, t, self.h * self.d_k), self.dtype,
                            self.tp)
