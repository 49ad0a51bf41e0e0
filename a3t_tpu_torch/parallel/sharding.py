"""Adam's moments sharded over the data axis (ZeRO-1): the port of
``shard_opt_state`` / ``moment_partition_spec`` (``a3t_tpu/parallel/
sharding.py:74-123``, the analogue of the reference's ``--sharded_ddp``).

The optimizer keeps its moments as flat float32 vectors in the
parameters' order (``train/optim.py``).  Over W ranks the vector of n
elements is padded with zeros to ``W * s`` elements, ``s = ceil(n / W)``,
and rank r owns the contiguous slice ``[r s, (r + 1) s)``: its ``mu``,
``nu`` and ``acc_grads`` are s long.  JAX instead splits each tensor of
8192 elements or more along its first dimension that W divides and keeps
the small ones replicated; the layouts differ and the numbers do not, as
each element's update depends on that element alone (and on the global
norm).

A step sums the flat gradients over the ranks and keeps the owned slice
(:func:`reduce_scatter_flat`, ``reduce_scatter_tensor``), and puts the
slices of the update back together on every rank (:func:`all_gather_flat`,
``all_gather_into_tensor``): one code path for every backend, as NCCL and
gloo both take these collectives on CPU and CUDA tensors.  At world size 1
each function returns its input.  ``param_partition_spec`` (the ``model``
axis) waits for ROADMAP A10b.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from a3t_tpu_torch.parallel.mesh import rank, world


def flat_slice(n: int, r=None, w=None) -> slice:
    """Rank ``r``'s slice of a flat vector of ``n`` elements padded to a
    multiple of ``w``: ``ceil(n / w)`` elements, the last rank's partly
    padding."""
    r = rank() if r is None else r
    w = world() if w is None else w
    s = -(-n // w)
    return slice(r * s, (r + 1) * s)


def _padded(x: torch.Tensor, w: int) -> torch.Tensor:
    s = -(-x.numel() // w)
    pad = s * w - x.numel()
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def shard_flat(x: torch.Tensor, r=None, w=None) -> torch.Tensor:
    """Rank ``r``'s slice of the full flat vector ``x`` (``x`` itself at
    world size 1)."""
    w = world() if w is None else w
    if w == 1:
        return x
    return _padded(x, w)[flat_slice(x.numel(), r, w)].clone()


def reduce_scatter_flat(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of the full flat vector ``x``, this rank's
    slice of it."""
    w = world()
    if w == 1:
        return x
    out = x.new_empty(-(-x.numel() // w))
    dist.reduce_scatter_tensor(out, _padded(x, w).contiguous())
    return out


def all_gather_flat(part: torch.Tensor, n: int) -> torch.Tensor:
    """The full flat vector of ``n`` elements from every rank's slice
    ``part`` (``part`` itself at world size 1)."""
    w = world()
    if w == 1:
        return part
    full = part.new_empty(part.numel() * w)
    dist.all_gather_into_tensor(full, part.contiguous())
    return full[:n]
