"""The mesh's ``data``, ``seq`` and ``model`` axes as process groups: the
port of ``a3t_tpu/parallel/mesh.py``.

The JAX package lays its devices out as ``devices.reshape(dp, sp, tp)``
with the axes ``(data, seq, model)`` (``devices.reshape(dp, tp)`` on the
axes ``(data, model)`` when sp = 1).  The ``data`` axis splits one global
batch by rows, and GSPMD reduces the loss's denominator, BatchNorm's
statistics and the gradients over it, so that a step on dp devices
computes what one device computes on the whole batch.  The ``seq`` axis
splits the frames of each row (context parallelism, ``parallel/
sequence.py``): GSPMD all-gathers the keys and values, exchanges the
convolutions' halos and reduces the same sums over it as over ``data``.
The ``model`` axis splits the attention heads and the feed-forward hidden
units (``parallel/sharding.py``), and GSPMD inserts the all-reduces that
put the halves back together (``parallel/tensor.py``).  The port runs one
process per card in a ``torch.distributed`` group of ``dp * sp * tp``
processes (NCCL on the card, gloo on the CPU) and keeps those
single-controller semantics on purpose:

* process ``r`` is ``(d, s, t)`` with ``r = (d * sp + s) * tp + t``, as
  the reshape lays the devices out: the tp ranks of one model group are
  adjacent, then the sp model groups of one data rank, so on one machine
  they are neighbours on NVLink;
* :func:`make_mesh` builds the subgroups: the data group of the ranks with
  the same ``s, t`` (size dp), the seq group of those with the same ``d,
  t`` (size sp), the model group of those with the same ``d, s`` (size
  tp), and the data x seq group of those with the same ``t`` (size dp *
  sp), over which the sums of the loss and of BatchNorm run;
* every rank builds the same global batch plan, and data rank d takes the
  rows :func:`row_block` ``[d B / dp, (d + 1) B / dp)`` of each global
  batch; the sp * tp ranks of one data rank take the same rows, and seq
  rank s their frames ``[s F / sp, (s + 1) F / sp)``;
* the loss divides each rank's numerator by the global masked count, and
  BatchNorm reduces its sums over the data (x seq) group through
  :func:`global_sum`, which is differentiable, so that the ranks'
  gradients sum to the gradient of the global loss;
* the optimizer sums the gradients over the data and seq groups
  (``parallel/sharding.py``, ``train/optim.py``).

A group of one, or no group at all, runs no collective: every helper here
is the identity there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from a3t_tpu_torch.device import resolve_device


# the layout of make_mesh: sp, tp, and this rank's groups; a group of None
# is the whole world (where the other axes have size 1)
_AXES = ("data", "seq", "model", "data_seq")
_MESH = {"sp": 1, "tp": 1, **dict.fromkeys(_AXES)}
# every subgroup made so far, by (sp, tp): new_group is a collective of the
# whole world, so each layout's groups are made once
_GROUPS: dict = {}


def world() -> int:
    """The number of processes: the group's world size, 1 without a
    group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the whole group, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def model_world() -> int:
    """The model axis's size, tp (1 without a group)."""
    return _MESH["tp"] if dist.is_initialized() else 1


def model_rank() -> int:
    """This process's place on the model axis, ``rank % tp``."""
    return rank() % model_world()


def seq_world() -> int:
    """The seq axis's size, sp (1 without a group)."""
    return _MESH["sp"] if dist.is_initialized() else 1


def seq_rank() -> int:
    """This process's place on the seq axis, ``(rank // tp) % sp``."""
    return (rank() // model_world()) % seq_world()


def data_world() -> int:
    """The data axis's size, dp = world / (sp * tp)."""
    return world() // (seq_world() * model_world())


def data_rank() -> int:
    """This process's place on the data axis, ``rank // (sp * tp)``."""
    return rank() // (seq_world() * model_world())


def data_group():
    """The group of this rank's data axis (the ranks with its seq and
    model indices); None is the whole world."""
    return _MESH["data"]


def seq_group():
    """The group of this rank's seq axis (the ranks with its data and model
    indices)."""
    return _MESH["seq"]


def model_group():
    """The group of this rank's model axis (the ranks with its data and
    seq indices)."""
    return _MESH["model"]


def _axis(group: str):
    """(size, group) of an axis by name: "data", "seq", "model" or
    "data_seq" (the data and seq axes together)."""
    size = {"data": data_world, "seq": seq_world, "model": model_world,
            "data_seq": lambda: data_world() * seq_world()}[group]()
    return size, _MESH[group]


def make_mesh(data_parallel=None, tensor_parallel: int = 1,
              sequence_parallel: int = 1) -> int:
    """Lay the group out as ``(data, seq, model)`` for a config's
    ``mesh.data_parallel``, ``mesh.tensor_parallel`` and
    ``mesh.sequence_parallel`` and return dp: None means every rank left
    (JAX ``make_mesh``), and ``dp * sp * tp`` must equal the number of
    processes.  A collective when the layout is new: every rank calls it
    with the same values."""
    w, tp, sp = world(), int(tensor_parallel), int(sequence_parallel)
    if tp < 1 or w % tp:
        raise ValueError(
            f"mesh.tensor_parallel={tp} does not divide the {w} "
            "process(es) (one per card)")
    if sp < 1 or w % (sp * tp):
        raise ValueError(
            f"mesh.sequence_parallel={sp} x mesh.tensor_parallel={tp} does "
            f"not divide the {w} process(es) (one per card)")
    dp = w // (sp * tp) if data_parallel is None else int(data_parallel)
    if dp * sp * tp != w:
        axes = (f"mesh.data_parallel={data_parallel} x "
                + (f"mesh.sequence_parallel={sp} x " if sp > 1 else "")
                + f"mesh.tensor_parallel={tp}")
        raise ValueError(
            f"{axes} does not cover the {w} process(es) (one per card); set "
            "data_parallel to their number over sequence_parallel x "
            "tensor_parallel, or leave it null")
    if (sp == 1 and tp == 1) or not dist.is_initialized():
        _MESH.update(sp=1, tp=1, **dict.fromkeys(_AXES))
        return dp
    if (sp, tp) not in _GROUPS:
        _GROUPS[(sp, tp)] = _make_groups(dp, sp, tp)
    _MESH.update(sp=sp, tp=tp, **_GROUPS[(sp, tp)])
    return dp


def _make_groups(dp: int, sp: int, tp: int) -> dict:
    """This rank's groups of the ``dp x sp x tp`` layout (None: the whole
    world, or an axis of size 1).  Every rank makes every group of every
    axis of size > 1, in the same order (``new_group`` is a collective)."""
    def r(d, s, t):
        return (d * sp + s) * tp + t

    me = rank()
    d0, s0, t0 = me // (sp * tp), (me // tp) % sp, me % tp
    groups = dict.fromkeys(_AXES)
    spans = {
        "data": (True, [
            ((s, t), [r(d, s, t) for d in range(dp)])
            for s in range(sp) for t in range(tp)], (s0, t0)),
        "model": (tp > 1, [((d, s), [r(d, s, t) for t in range(tp)])
                           for d in range(dp) for s in range(sp)], (d0, s0)),
        "seq": (sp > 1, [((d, t), [r(d, s, t) for s in range(sp)])
                         for d in range(dp) for t in range(tp)], (d0, t0)),
        "data_seq": (sp > 1 and tp > 1, [
            ((t,), [r(d, s, t) for d in range(dp) for s in range(sp)])
            for t in range(tp)], (t0,)),
    }
    # PR 19's order at sp = 1 (data, then model), then the seq axis's
    for axis in ("data", "model", "seq", "data_seq"):
        wanted, members, mine = spans[axis]
        if not wanted:
            continue
        for key, ranks in members:
            g = dist.new_group(ranks)
            if key == mine:
                groups[axis] = g
    if sp == 1:
        groups["data_seq"] = groups["data"]
    return groups



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
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0)
    if backend == "nccl":
        _one_rank_per_card(store, num_processes, process_id)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    _GROUPS.clear()
    _MESH.update(sp=1, tp=1, **dict.fromkeys(_AXES))


def _one_rank_per_card(store, n: int, r: int) -> None:
    """Raise unless every rank has a card of its own: NCCL cannot put two
    ranks of one communicator on one card.  Each rank posts its host and
    card to the group's store and reads the others'."""
    import socket

    mine = f"{socket.gethostname()}:{torch.cuda.current_device()}"
    store.set(f"a3t_card_{r}", mine)
    cards = [store.get(f"a3t_card_{q}").decode() for q in range(n)]
    same = [q for q in range(n) if cards[q] == mine]
    if len(same) > 1:
        raise RuntimeError(
            f"ranks {same} share the card {mine}; NCCL cannot put two ranks "
            "of one group on one card: give each rank a card of its own")


def rank_device(device=None) -> torch.device:
    """The device this rank trains on: ``cuda:{rank mod cards}`` for cuda
    over several processes, else ``device`` as :func:`resolve_device`
    gives it (cuda unless the caller asks for the CPU; no card raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world() > 1 and dev.index is None:
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return dev


def row_block(batch_size: int, r=None, w=None) -> slice:
    """Data rank ``r``'s rows ``[r B / W, (r + 1) B / W)`` of a global batch
    of ``batch_size`` rows over W data ranks (JAX's ``P("data")`` split); B
    must be a multiple of W, as the batcher's ``batch_multiple = W`` makes
    it."""
    r = data_rank() if r is None else r
    w = data_world() if w is None else w
    if batch_size % w:
        raise ValueError(f"a batch of {batch_size} rows does not split over "
                         f"{w} ranks")
    n = batch_size // w
    return slice(r * n, (r + 1) * n)


class _GlobalSum(torch.autograd.Function):
    """all_reduce(sum) over a group whose backward is the all_reduce of the
    gradient: every rank's term reaches every rank's result."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(x: torch.Tensor, group: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the data axis (``group="data_seq"``: over the
    data and seq axes), differentiable; ``x`` itself where the axes have
    size 1."""
    size, g = _axis(group)
    return _GlobalSum.apply(x, g) if size > 1 else x


def all_reduce_sum(x: torch.Tensor, group: str = "data") -> torch.Tensor:
    """The sum of ``x`` (no gradient) over an axis by name: "data",
    "seq", "model" or "data_seq" (the data and seq axes); ``x`` where the
    axis has size 1."""
    size, g = _axis(group)
    if size == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=g)
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
