"""The model axis's collectives: Megatron's two operators, the all-reduces
that GSPMD inserts around the split projections of ``a3t_tpu/parallel/
sharding.py``'s layout.

A block's attention and each of its feed-forwards run on the rank's slice
of the heads or hidden units (``parallel/sharding.py``):

* :func:`copy_to_model` goes before the projections split by output: the
  identity forward; backward, the all-reduce over the model group of the
  input's gradient, whose tp parts each hold one slice's contribution;
* :func:`reduce_from_model` goes after a projection split by input, before
  its bias: the all-reduce of the tp partial products forward; the
  identity backward.

So a replicated activation and its gradient are the same on every rank of
a model group, and a step on tp ranks computes what one process computes.
At tp = 1 both are the identity, with no collective.  A module built for
tp ranks (:class:`ModelShard`) raises when the live group's model axis
(``parallel/mesh.py``) has another size, rather than leave a partial sum
unreduced.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from a3t_tpu_torch.parallel.mesh import model_group, model_world


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A module's place on the model axis: slice ``rank`` of ``size``."""

    rank: int = 0
    size: int = 1

    def part(self, n: int, what: str) -> int:
        """The rank's share of ``n`` heads or units."""
        if n % self.size:
            raise ValueError(f"{what} {n} does not split over "
                             f"tensor_parallel={self.size}")
        return n // self.size


def _check(tp: int) -> None:
    if model_world() != tp:
        raise RuntimeError(
            f"a module split over {tp} ranks runs where the model axis has "
            f"{model_world()} (parallel.mesh.make_mesh)")


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=model_group())
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor, tp: int) -> torch.Tensor:
    """``x``, whose gradient is summed over the model group of ``tp``
    ranks in the backward pass."""
    if tp == 1:
        return x
    _check(tp)
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor, tp: int) -> torch.Tensor:
    """The sum of the ``tp`` ranks' partial ``x``; its gradient passes
    through."""
    if tp == 1:
        return x
    _check(tp)
    return _ReduceFromModel.apply(x)
