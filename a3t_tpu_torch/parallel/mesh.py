"""The data axis as one process per card: the port of
``a3t_tpu/parallel/mesh.py``.

The JAX package's ``data`` mesh axis splits one global batch by rows over
its devices, and GSPMD reduces the loss's denominator, BatchNorm's
statistics and the gradients over the axis, so that a step on W devices
computes what one device computes on the whole batch.  The port runs one
process per card in a ``torch.distributed`` group of world size W (NCCL
on the card, gloo on the CPU) and keeps those single-controller semantics
on purpose:

* every rank builds the same global batch plan, and rank r takes the rows
  :func:`row_block` ``[r B / W, (r + 1) B / W)`` of each global batch;
* the loss divides each rank's numerator by the global masked count, and
  BatchNorm reduces its sums over the ranks through :func:`global_sum`,
  which is differentiable, so that the rank's gradients sum to the
  gradient of the global loss;
* the optimizer sums the gradients over the ranks (``parallel/
  sharding.py``, ``train/optim.py``).

World size 1, with or without a group, runs no collective at all: every
helper here is the identity there.  The ``model`` and ``seq`` axes are not
ported (ROADMAP A10b, A10c).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from a3t_tpu_torch.device import resolve_device


def world() -> int:
    """The data axis's size: the group's world size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's place on the data axis, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_multihost(coordinator: str, num_processes: int,
                         process_id: int, backend=None,
                         device="cuda") -> None:
    """Join the group of ``num_processes`` processes (one per card) whose
    rank 0 listens at ``coordinator`` (``host:port``), as ``process_id``:
    the analogue of ``jax.distributed.initialize``.  ``backend`` None is
    NCCL for a cuda ``device`` and gloo for the CPU; on the card the
    process's current device becomes its rank's (:func:`rank_device`)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--host-id {process_id} outside [0, "
                         f"{num_processes})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def rank_device(device=None) -> torch.device:
    """The device this rank trains on: ``cuda:{rank mod cards}`` for cuda
    at world size > 1, else ``device`` as :func:`resolve_device` gives it
    (cuda unless the caller asks for the CPU; no card raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world() > 1 and dev.index is None:
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return dev


def data_parallel(requested) -> int:
    """The data axis's size for a config's ``mesh.data_parallel``: None
    means every rank (JAX ``make_mesh``); any other value must equal the
    world size."""
    w = world()
    if requested is not None and int(requested) != w:
        raise ValueError(
            f"mesh.data_parallel={requested} but {w} process(es) train; "
            "set it to the number of processes (one per card) or leave it "
            "null")
    return w


def row_block(batch_size: int, r=None, w=None) -> slice:
    """Rank ``r``'s rows ``[r B / W, (r + 1) B / W)`` of a global batch of
    ``batch_size`` rows (JAX's ``P("data")`` split); B must be a multiple
    of W, as the batcher's ``batch_multiple = W`` makes it."""
    r = rank() if r is None else r
    w = world() if w is None else w
    if batch_size % w:
        raise ValueError(f"a batch of {batch_size} rows does not split over "
                         f"{w} ranks")
    n = batch_size // w
    return slice(r * n, (r + 1) * n)


class _GlobalSum(torch.autograd.Function):
    """all_reduce(sum) whose backward is the all_reduce of the gradient:
    every rank's term reaches every rank's result."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable; ``x`` itself at
    world size 1."""
    return _GlobalSum.apply(x) if world() > 1 else x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (no gradient); ``x`` at world size
    1."""
    if world() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def agree(value):
    """Rank 0's ``value`` (anything picklable) on every rank: a decision
    taken before a collective (stop for the walltime, stop early, where to
    resume) must be the same on all ranks or the run hangs."""
    if world() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, 0)
    return box[0]


def every(flag: bool) -> list:
    """Every rank's ``flag``, in rank order, on every rank (``[flag]`` at
    world size 1)."""
    if world() == 1:
        return [flag]
    flags = [None] * world()
    dist.all_gather_object(flags, bool(flag))
    return flags


def barrier() -> None:
    """Wait for every rank (nothing at world size 1)."""
    if world() > 1:
        dist.barrier()
