"""The seq axis's collectives: what GSPMD inserts where
``a3t_tpu/train/train_step.py::constrain_time_sharding`` shards the frames
of the featurized batch over the mesh's ``seq`` axis (context
parallelism).

A seq rank holds, of each row of its data rank's batch, the frame block
``[s F / sp, (s + 1) F / sp)`` and the whole ``tail`` after the frames
(the text: tens of phones against hundreds to thousands of frames).  A
:class:`SeqLayout` names those rows; everything per row stays local, and
three operators carry what crosses a block's edge:

* :func:`frame_block`, the rank's block of a whole (B, F, ...) tensor;
* :func:`gather_frames`, the differentiable all-gather of the sp blocks
  in global order, whose backward is the reduce-scatter that sums each
  block's gradient over the ranks and returns it to its owner (the keys
  and values of attention, the states that length regulation reads);
* :func:`halo_pad`, the halo exchange of a 'same'-padded convolution over
  the sequence ``[frames ; tail]``: each block takes (k - 1) / 2 rows from
  its neighbours (zeros before the first block, the first tail rows after
  the last) and the tail the last frames, which only the last rank owns;
  :func:`next_row` is the one-row halo of the legacy relative shift.

The halos travel as one all-gather over the seq group of each block's
first and last rows; its backward returns each halo row's gradient to its
owner.  A gather's backward is a collective too, so every rank uses some
of every gathered tensor (its gradient may be zero), and the ranks' graphs
run the same collectives in the same order.  Every operator is the identity at sp = 1 (a layout of None), and
no collective runs there.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from a3t_tpu_torch.parallel.mesh import seq_group, seq_rank, seq_world


@dataclasses.dataclass(frozen=True)
class SeqLayout:
    """Seq rank ``rank`` of ``size``: of a whole sequence of ``frames``
    frames then ``tail`` rows, its local rows are the frame block
    ``[offset, offset + block)`` and the whole tail."""

    frames: int
    tail: int
    rank: int
    size: int

    @property
    def block(self) -> int:
        return self.frames // self.size

    @property
    def offset(self) -> int:
        return self.rank * self.block

    @property
    def length(self) -> int:
        """The whole sequence's rows, ``frames + tail``."""
        return self.frames + self.tail

    def with_tail(self, tail: int) -> "SeqLayout":
        return dataclasses.replace(self, tail=int(tail))

    def speech(self) -> "SeqLayout":
        """The layout of the frames alone."""
        return self.with_tail(0)

    def rows(self, device=None) -> torch.Tensor:
        """(block + tail,) int64 on ``device``: the global index of each
        local row, built once per layout and device."""
        return _row_index(self, torch.device(device or "cpu"))

    def q_rows(self) -> tuple:
        """The fused attention kernels' (split, offset) of the local query
        rows (``ops/fused_attention.py``)."""
        return self.block, self.offset

    def drop_rows(self, dim: int, device) -> tuple:
        """A dropout site's ``rows`` (``models/dropout.py``) for a tensor on
        ``device``: the local rows along ``dim`` of a whole tensor of
        ``length`` rows there."""
        return dim, self.rows(device), self.length


@functools.lru_cache(maxsize=64)
def _row_index(seq: SeqLayout, device: torch.device) -> torch.Tensor:
    return torch.cat([torch.arange(seq.offset, seq.offset + seq.block),
                      torch.arange(seq.frames, seq.length)]).to(device)


def seq_layout(frames: int, tail: int = 0):
    """This rank's :class:`SeqLayout` of ``frames`` frames and ``tail``
    rows on the live mesh's seq axis; None at sp = 1.  Raises, with JAX's
    message, unless ``frames`` splits over sp."""
    sp = seq_world()
    if sp == 1:
        return None
    if frames % sp:
        raise ValueError(
            f"sequence parallelism needs the frame bucket ({frames}) to be "
            f"a multiple of the seq axis ({sp}); adjust "
            "BatcherConfig.bucket_frames")
    return SeqLayout(int(frames), int(tail), seq_rank(), sp)


def frame_block(x: torch.Tensor, seq, dim: int = 1) -> torch.Tensor:
    """The rank's block of the whole frames of ``x`` along ``dim`` (``x``
    itself for a layout of None); its gradient is zero off the block."""
    if seq is None:
        return x
    return x.narrow(dim, seq.offset, seq.block)


def _gather(x: torch.Tensor, sp: int) -> torch.Tensor:
    """The sp ranks' ``x`` stacked along dim 0, in seq-rank order."""
    x = x.contiguous()
    out = x.new_empty((sp * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=seq_group())
    return out


def _scatter_sum(x: torch.Tensor, sp: int) -> torch.Tensor:
    """This rank's block along dim 0 of the sum of the sp ranks' ``x``."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // sp,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=seq_group())
    return out


class _GatherFrames(torch.autograd.Function):
    """All-gather of the blocks along dim 0; backward, the reduce-scatter
    of the gradient (each rank's sum of every rank's gradient of its
    block)."""

    @staticmethod
    def forward(ctx, x, sp: int):
        ctx.sp = sp
        return _gather(x, sp)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_sum(grad, ctx.sp), None


def gather_frames(x: torch.Tensor, seq, dim: int = 1) -> torch.Tensor:
    """The whole frames along ``dim`` from every seq rank's block ``x``,
    differentiable (``x`` itself for a layout of None).  Booleans and
    integers travel without a gradient."""
    if seq is None:
        return x
    y = x.movedim(dim, 0)
    if not (x.is_floating_point() and x.requires_grad):
        wire = y.to(torch.int32) if x.dtype == torch.bool else y
        out = _gather(wire, seq.size).to(x.dtype)
    else:
        out = _GatherFrames.apply(y, seq.size)
    return out.movedim(0, dim)


def _edges(x: torch.Tensor, seq, m: int, dim: int):
    """Every block's first and last ``m`` rows along ``dim``: two lists of
    sp tensors, in seq-rank order (one all-gather)."""
    block = x.narrow(dim, 0, seq.block)
    both = torch.cat([block.narrow(dim, 0, m),
                      block.narrow(dim, seq.block - m, m)], dim)
    every = gather_frames(both, seq, dim).split(m, dim)
    return list(every[0::2]), list(every[1::2])


def _zeros_like_rows(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


def _take(parts, n: int, dim: int, last: bool, like) -> torch.Tensor:
    """The first (or last) ``n`` rows of ``parts`` concatenated along
    ``dim``, padded with zeros where they hold fewer."""
    have = torch.cat(parts, dim) if parts else _zeros_like_rows(like, 0, dim)
    k = have.shape[dim]
    if k >= n:
        return have.narrow(dim, k - n, n) if last else have.narrow(dim, 0, n)
    pad = _zeros_like_rows(like, n - k, dim)
    return torch.cat([pad, have] if last else [have, pad], dim)


def halo_pad(x: torch.Tensor, h: int, seq, dim: int = -1) -> torch.Tensor:
    """The input of a 'same'-padded convolution of half-width ``h`` over
    the whole sequence ``[frames ; tail]``, for the local rows ``x``
    (``[block ; tail]`` along ``dim``): ``[left, block, right]`` and, with
    a tail, ``[last frames, tail, zeros]`` after it, each side h rows.  A
    convolution with no padding over it, then :func:`halo_trim`, gives
    the whole convolution's rows of this rank."""
    dim %= x.dim()
    if h == 0:
        return x
    m = min(h, seq.block)
    first, last = _edges(x, seq, m, dim)
    s = seq.rank
    block = x.narrow(dim, 0, seq.block)
    tail = x.narrow(dim, seq.block, seq.tail)
    # blocks nearer than h rows are whole in the edges when m = block
    left = _take(last[:s], h, dim, True, x)
    right = _take(first[s + 1:] + [tail], h, dim, False, x)
    pieces = [left, block, right]
    if seq.tail:
        pieces += [_take(last, h, dim, True, x), tail,
                   _zeros_like_rows(x, h, dim)]
    return torch.cat(pieces, dim)


def halo_trim(y: torch.Tensor, h: int, seq, dim: int = -1) -> torch.Tensor:
    """The rank's rows of the output of a padding-free convolution over
    :func:`halo_pad`'s input: the block's and, with a tail, the tail's
    (``y`` itself otherwise)."""
    if not seq.tail or h == 0:
        return y
    dim %= y.dim()
    return torch.cat([y.narrow(dim, 0, seq.block),
                      y.narrow(dim, seq.block + 2 * h, seq.tail)], dim)


def next_row(x: torch.Tensor, seq, dim: int = 1) -> torch.Tensor:
    """The row after the rank's block along ``dim``: the next block's first
    row, the first tail row after the last block (zeros without a tail).
    Every rank takes its row out of one tensor built from the gathered
    rows, so that the gather's backward (a collective) runs on every rank,
    the last one's included."""
    first, _ = _edges(x, seq, 1, dim)
    after = (x.narrow(dim, seq.block, 1) if seq.tail
             else _zeros_like_rows(x, 1, dim))
    return torch.cat(first[1:] + [after], dim).narrow(dim, seq.rank, 1)
