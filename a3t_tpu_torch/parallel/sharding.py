"""The parameters split over the model axis and Adam's moments over the
data axis: the port of ``a3t_tpu/parallel/sharding.py``.

**The model axis** (``param_partition_spec``, JAX :32-58, Megatron's
split).  The attention's q, k, v and ``linear_pos`` projections and the
feed-forwards' up-projections (``w_1``, of both feed-forwards of a block)
are split by output over the tp ranks of a model group, ``linear_out`` and
the down-projections (``w_2``) by input; everything else is replicated.
A torch ``Linear.weight`` is (out, in) and a ``Conv1d.weight`` (out, in,
k), so a split by output takes dim 0 of the weight and of the bias, and a
split by input dim 1 of the weight and none of the bias, which the rank
adds once after the model group's all-reduce (``parallel/tensor.py``).
``pos_bias_u``/``pos_bias_v`` (H, d_k) are replicated in JAX, but a rank
reads only its heads' rows, so it holds only those.  Rank t of tp holds
the t-th of tp equal slices: :func:`shard_state` cuts a full state into a
rank's, :func:`gather_state` puts the ranks' back together, and
:class:`FlatLayout` places a rank's flat parameter vector in the full one.

**The data axis** (ZeRO-1, ``shard_opt_state`` / ``moment_partition_spec``,
JAX :74-123, the analogue of the reference's ``--sharded_ddp``).  The
optimizer keeps its moments as flat float32 vectors in the
parameters' order (``train/optim.py``).  Over W ranks the vector of n
elements is padded with zeros to ``W * s`` elements, ``s = ceil(n / W)``,
and rank r owns the contiguous slice ``[r s, (r + 1) s)``: its ``mu``,
``nu`` and ``acc_grads`` are s long.  JAX instead splits each tensor of
8192 elements or more along its first dimension that W divides and keeps
the small ones replicated; the layouts differ and the numbers do not, as
each element's update depends on that element alone (and on the global
norm).

The seq axis (``parallel/sequence.py``) splits no parameter and no
moment: its ranks hold the same slices as their data rank's, as JAX's
``moment_partition_spec`` slices over ``data`` alone.  A step sums the
flat gradients over the seq group (``all_reduce``) and over the data
group, keeping the owned slice (:func:`reduce_scatter_flat`,
``reduce_scatter_tensor``), and puts
the slices of the update back together on every rank of it
(:func:`all_gather_flat`, ``all_gather_into_tensor``): one code path for
every backend, as NCCL and gloo both take these collectives on CPU and
CUDA tensors.  Where an axis has size 1 each function returns its input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from a3t_tpu_torch.parallel.mesh import (all_reduce_sum, data_group,
                                         data_rank, data_world, model_group,
                                         model_world)

# the projections split by output and by input over the model axis, by the
# name of their module in an attention block (``self_attn``) or a
# feed-forward (``feed_forward``, ``feed_forward_macaron``)
_ATTN_COLUMN = ("linear_q", "linear_k", "linear_v", "linear_pos")
_ATTN_ROW = ("linear_out",)


def param_partition_spec(name: str) -> Optional[int]:
    """The dimension along which the model axis splits the state entry
    ``name`` (an ESPnet name of the port's models), None when it is
    replicated."""
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if "self_attn" in parts:
        if leaf in ("pos_bias_u", "pos_bias_v") or owner in _ATTN_COLUMN:
            return 0
        if owner in _ATTN_ROW:
            return 1 if leaf == "weight" else None
    if any(p.startswith("feed_forward") for p in parts):
        if owner == "w_1":
            return 0
        if owner == "w_2":
            return 1 if leaf == "weight" else None
    return None


def _piece(n: int, tp: int, name: str) -> int:
    if n % tp:
        raise ValueError(f"{name}: {n} does not split over {tp} ranks of "
                         "the model axis")
    return n // tp


def shard_state(state: dict, t: int, tp: int) -> dict:
    """Rank ``t``'s slice of a full ``{name: tensor}`` state over a model
    axis of ``tp`` ranks (``state`` itself at tp = 1)."""
    if tp == 1:
        return state
    out = {}
    for name, v in state.items():
        dim = param_partition_spec(name)
        if dim is None:
            out[name] = v
        else:
            n = _piece(v.shape[dim], tp, name)
            out[name] = v.narrow(dim, t * n, n).clone()
    return out


def gather_state(parts: list) -> dict:
    """The full state from the tp ranks' states ``parts`` (rank order):
    the inverse of :func:`shard_state`."""
    return {name: v if param_partition_spec(name) is None else
            torch.cat([p[name] for p in parts], param_partition_spec(name))
            for name, v in parts[0].items()}


def all_gather_state(state: dict) -> dict:
    """The full state from every rank of this rank's model group (a
    collective of the group; ``state`` itself at tp = 1)."""
    tp = model_world()
    if tp == 1:
        return state
    parts = [dict() for _ in range(tp)]
    for name, v in state.items():
        if param_partition_spec(name) is None:
            for p in parts:
                p[name] = v
            continue
        got = [torch.empty_like(v) for _ in range(tp)]
        dist.all_gather(got, v.contiguous(), group=model_group())
        for p, x in zip(parts, got):
            p[name] = x
    return gather_state(parts)


class FlatLayout:
    """Where rank ``t``'s flat vector of parameters (``named``: their
    names and local shapes, in order) lies in the full flat vector of one
    process, over a model axis of ``tp`` ranks."""

    def __init__(self, named, t: int = 0, tp: int = 1):
        self.t, self.tp = t, tp
        self.names = [n for n, _ in named]
        self.dims = [param_partition_spec(n) if tp > 1 else None
                     for n in self.names]
        self.local = [tuple(s) for _, s in named]
        self.full = [s if d is None else
                     s[:d] + (s[d] * tp,) + s[d + 1:]
                     for s, d in zip(self.local, self.dims)]
        self.n_local = sum(math.prod(s) for s in self.local)
        self.n_full = sum(math.prod(s) for s in self.full)
        self._mask = None

    @classmethod
    def of(cls, model: torch.nn.Module) -> "FlatLayout":
        """The layout of ``model``'s parameters: those of its model-axis
        slice (``model.shard``) when it has one."""
        shard = getattr(model, "shard", None)
        named = [(n, p.shape) for n, p in model.named_parameters()]
        return (cls(named) if shard is None
                else cls(named, shard.rank, shard.size))

    def local_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's flat vector from the full one (``full`` at tp = 1)."""
        if self.tp == 1:
            return full
        out, i = [], 0
        for s, d in zip(self.full, self.dims):
            n = math.prod(s)
            x = full[i:i + n]
            if d is not None:
                x = x.view(s).narrow(d, self.t * s[d] // self.tp,
                                     s[d] // self.tp)
            out.append(x.reshape(-1))
            i += n
        return torch.cat(out)

    def full_of(self, parts: list) -> torch.Tensor:
        """The full flat vector from the tp ranks' flat vectors ``parts``
        (rank order); a replicated parameter is taken from rank 0's."""
        if self.tp == 1:
            return parts[0]
        out, i = [], 0
        for s, d in zip(self.local, self.dims):
            n = math.prod(s)
            if d is None:
                out.append(parts[0][i:i + n])
            else:
                out.append(torch.cat([p[i:i + n].view(s) for p in parts],
                                     d).reshape(-1))
            i += n
        return torch.cat(out)

    def split_mask(self, device) -> torch.Tensor:
        """(n_local,) bool: True where this rank's element belongs to a
        parameter the model axis splits."""
        if self._mask is None or self._mask.device != torch.device(device):
            self._mask = torch.cat([
                torch.full((math.prod(s),), d is not None, dtype=torch.bool)
                for s, d in zip(self.local, self.dims)]).to(device)
        return self._mask


def all_gather_flat_model(x: torch.Tensor, layout: FlatLayout
                          ) -> torch.Tensor:
    """The full flat vector from this model group's flat vectors ``x`` (a
    collective of the group; ``x`` itself at tp = 1)."""
    if layout.tp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(layout.tp)]
    dist.all_gather(parts, x.contiguous(), group=model_group())
    return layout.full_of(parts)


def flat_slice(n: int, r=None, w=None) -> slice:
    """Data rank ``r``'s slice of a flat vector of ``n`` elements padded to
    a multiple of ``w``: ``ceil(n / w)`` elements, the last rank's partly
    padding."""
    r = data_rank() if r is None else r
    w = data_world() if w is None else w
    s = -(-n // w)
    return slice(r * s, (r + 1) * s)


def _padded(x: torch.Tensor, w: int) -> torch.Tensor:
    s = -(-x.numel() // w)
    pad = s * w - x.numel()
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def shard_flat(x: torch.Tensor, r=None, w=None) -> torch.Tensor:
    """Data rank ``r``'s slice of the flat vector ``x`` (``x`` itself at
    dp = 1)."""
    w = data_world() if w is None else w
    if w == 1:
        return x
    return _padded(x, w)[flat_slice(x.numel(), r, w)].clone()


def reduce_scatter_flat(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data and seq groups of the flat vector ``x``, this
    rank's data slice of it (the same on every rank of a seq group)."""
    x = all_reduce_sum(x, "seq")
    w = data_world()
    if w == 1:
        return x
    out = x.new_empty(-(-x.numel() // w))
    dist.reduce_scatter_tensor(out, _padded(x, w).contiguous(),
                               group=data_group())
    return out


def all_gather_flat(part: torch.Tensor, n: int) -> torch.Tensor:
    """The flat vector of ``n`` elements from every data rank's slice
    ``part`` (``part`` itself at dp = 1)."""
    w = data_world()
    if w == 1:
        return part
    full = part.new_empty(part.numel() * w)
    dist.all_gather_into_tensor(full, part.contiguous(), group=data_group())
    return full[:n]
